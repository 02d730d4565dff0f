"""PyTorch and CUDA port of the rollout data plane (``repro`` is the JAX reference).

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device present, ``device=None`` raises.
"""
