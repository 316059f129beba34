"""PyTorch / CUDA port of ``text2nerf_tpu`` for NVIDIA Hopper (sm_90a).

The serving path (a TensoRF field loaded from an npz checkpoint, rendered
through the adaptive compacted renderer), the train step, and the stage-1
seed fit (``engine/trainer.py`` ``reconstruction``: the scene bootstrap,
stage 1 and stage 3 with their milestones, evals and the final
checkpoint).  Three hand-written CUDA kernels carry them
(``ops/kernels``): the factor-feature gather, its scatter-add backward,
and the fused ``MLP_Fea_noview`` shading head.  Every kernel keeps a plain
PyTorch version beside it, which runs only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`text2nerf_tpu_torch.device`).
"""
