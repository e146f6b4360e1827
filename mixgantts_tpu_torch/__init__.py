"""mixgantts_tpu_torch: the PyTorch/CUDA port of mixgantts_tpu for one NVIDIA
H100 (Hopper, sm_90a).

Plain tensor code is PyTorch; every Pallas TPU kernel of the JAX package is
a CUDA kernel written by hand under `csrc/`, built with nvcc at first use
and bound with ctypes.  The package imports nothing of JAX and nothing of
`mixgantts_tpu`.  Entry points (the models, `TTSPipeline`, the synthesis
CLI `python -m mixgantts_tpu_torch.cli.synthesize`, and the training API
of `mixgantts_tpu_torch.train`) run on `cuda` unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
