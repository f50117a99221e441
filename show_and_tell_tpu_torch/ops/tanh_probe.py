"""The tanh probe: the floor of the attention's score pass.

    out[b, d] = sum_k sum_l tanh(ce[b, l, d] + hp[b, k, d])        (fp32)

Just the tanh of the score pass, summed: no product with w_att, no softmax
and no context. The JAX package's attention benchmark times it to learn what
the tanh alone costs on its chip; here the kernel of ``csrc/tanh_probe.cu``
takes the form of the tanh as an argument (``TANH_FORMS``), so that one source
measures the card's rate for each form the attention kernels could use.

``tanh_probe`` launches the kernel for CUDA tensors and runs
``tanh_probe_reference`` for CPU tensors. On a CUDA tensor it never falls
back: the launch succeeds or it raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from show_and_tell_tpu_torch.ops import cuda_lib

# the kernel's `Form`, in its order: the tanh of bf16 pairs (run as one
# special-function operation per half); one operation per tanh in fp32 (~2^-11
# relative error); 1 - 2 / (1 + 2^(2x log2 e)) from ex2.approx and rcp.approx
# (two operations, absolute error below 5e-7); and the precise tanhf
TANH_FORMS = ("bf16x2", "approx_f32", "ex2_rcp", "precise")
# the form that meets the dtype's tolerance at the least cost
DEFAULT_FORM = {torch.bfloat16: "bf16x2", torch.float32: "ex2_rcp"}


def tanh_probe_reference(ce: torch.Tensor, hp: torch.Tensor) -> torch.Tensor:
    """Plain version: ce [B, L, D], hp [B, K, D] -> out [B, D] fp32. The sum
    ce + hp and its tanh are formed in the inputs' dtype, as the JAX probe's
    body forms them; the accumulation over k and l is fp32. Every form of
    the kernel is this one function."""
    t = torch.tanh(ce[:, None, :, :] + hp[:, :, None, :])  # [B, K, L, D]
    return t.sum(dim=(1, 2), dtype=torch.float32)


def tanh_probe(ce: torch.Tensor, hp: torch.Tensor, form: Optional[str] = None) -> torch.Tensor:
    """out [B, D] fp32 from ce [B, L, D] and hp [B, K, D] of one dtype (fp32
    or bf16): the kernel for CUDA tensors, with the tanh by ``form`` (a name
    of ``TANH_FORMS``; default: ``DEFAULT_FORM`` of the dtype), counted under
    ``tanh_probe`` by form; the plain version for CPU tensors."""
    if form is not None and form not in TANH_FORMS:
        raise ValueError(f"unknown tanh form {form!r}; options: {TANH_FORMS}")
    if not ce.is_cuda:
        return tanh_probe_reference(ce, hp)
    name = "tanh_probe"
    cuda_lib.check_operands(name, ce.device, ce=ce, hp=hp)
    if ce.dim() != 3 or hp.dim() != 3 or hp.shape[0] != ce.shape[0] or hp.shape[2] != ce.shape[2]:
        raise ValueError(f"{name}: ce {tuple(ce.shape)} must be [B, L, D] and hp {tuple(hp.shape)} [B, K, D]")
    if ce.dtype != hp.dtype:
        raise TypeError(f"{name}: ce and hp dtypes differ")
    code = cuda_lib.dtype_code(ce)
    form = form or DEFAULT_FORM[ce.dtype]
    if form == "bf16x2" and ce.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the bf16x2 form takes bfloat16 inputs, got {ce.dtype}")
    B, L, D = ce.shape
    K = hp.shape[1]
    if not 1 <= K <= 8 or B > 65535:
        raise ValueError(f"{name}: K={K}, B={B}: the kernel takes K 1..8 and B up to 65535")
    out = torch.empty((B, D), dtype=torch.float32, device=ce.device)
    if B == 0 or D == 0:
        return out
    if L == 0:
        return out.zero_()
    err = cuda_lib.library("tanh_probe.cu").sat_tanh_probe(
        cuda_lib.ptr(ce), cuda_lib.ptr(hp), cuda_lib.ptr(out), B, K, L, D, code,
        TANH_FORMS.index(form), int(cuda_lib.vectorizable((D,), ce, hp)), cuda_lib.stream(ce.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.count(name, form)
    return out
