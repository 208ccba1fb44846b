"""The plain reference of HTR-VT: plain PyTorch in float32, written from the
published model (Li et al., "HTR-VT", Pattern Recognition 2025,
arXiv:2409.08573; ``model/HTR_VT.py`` and ``model/resnet18.py``) and the
recipe (``run/iam.sh``: span masking 0.4 / 8, SAM rho 0.05 around AdamW,
the EMA), with the port's documented numerics where the paper leaves a
choice (the flax BatchNorm statistics, the parameterless input and logit
LayerNorms, the static A8W8 scheme). It imports nothing of the program,
of JAX or of the JAX package, and takes nothing the program made: weights
come from the benchmark's seed, and every quantization scale is worked
out here again.
"""
