"""The arithmetic the reference runs in.

`FULL` is what the configurations state: float32 with TF32 off, and the
operands of the four hand-written kernels (the denoiser's residual stack
and the MRF convolutions) rounded to bf16, their products summed in fp32.
`CONTROL` is the next precision below, the step that would tempt a later
change: TF32 for the float32 parts and fp8 (e4m3, scaled per tensor) for
the kernels' bf16 operands.  A run of the reference in `CONTROL`, put in
the program's place, must come out as not correct.
"""

import contextlib
from dataclasses import dataclass

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


@dataclass(frozen=True)
class Arith:
    tf32: bool          # TF32 for the float32 convolutions and matmuls
    kernel: str         # the kernels' operand type: "bf16" or "fp8"

    def operand(self, t):
        """t rounded to the kernels' operand type, returned in fp32."""
        if self.kernel == "bf16":
            return t.to(torch.bfloat16).float()
        scale = FP8_MAX / t.abs().amax().clamp(min=1e-30)
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    @contextlib.contextmanager
    def context(self):
        """TF32 as this arithmetic states, restored on exit."""
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


FULL = Arith(tf32=False, kernel="bf16")
CONTROL = Arith(tf32=True, kernel="fp8")
