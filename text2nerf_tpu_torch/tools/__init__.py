"""The product tools of the port (port of ``tools/compute_metrics.py``,
``report_phases.py``, ``rebuild_scene_snapshot.py``,
``smoke_real_weights.py`` and ``run_full_schedule.py``), each runnable as
``python -m text2nerf_tpu_torch.tools.<name>``.  They import ``torch``
and the port, never JAX, and print the same JSON keys as the JAX tools."""
