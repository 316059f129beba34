"""PyTorch / CUDA port of ``text2nerf_tpu`` for NVIDIA Hopper (sm_90a).

The serving path (a TensoRF field loaded from an npz checkpoint, rendered
through the adaptive compacted renderer), the train step, and the fit
(``engine/trainer.py`` ``reconstruction``: the scene bootstrap, stage 1,
scene expansion and stage 2, stage 3, with their milestones, evals and
the final checkpoint), on the procedural services or on the Stable
Diffusion 2, CLIP and boosted LeReS depth networks
(``models/diffusion.py``, ``models/clip.py``, ``models/leres.py``,
``services/``), started from the command line (``python -m
text2nerf_tpu_torch.main``).  Three hand-written CUDA kernels carry them
(``ops/kernels``): the factor-feature gather, its scatter-add backward,
and the fused ``MLP_Fea_noview`` shading head.  Every kernel keeps a plain
PyTorch version beside it, which runs only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`text2nerf_tpu_torch.device`).
"""
