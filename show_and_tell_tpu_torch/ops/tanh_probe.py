"""The tanh probe: the floor of the attention's score pass.

    out[b, d] = sum_k sum_l tanh(ce[b, l, d] + hp[b, k, d])        (fp32)

Just the tanh of the score pass, summed: no product with w_att, no softmax
and no context. The JAX package's attention benchmark times it to learn what
the tanh alone costs on its chip; here the kernel of ``csrc/tanh_probe.cu``
takes the form of the tanh as an argument (``TANH_FORMS``), so that one source
measures the card's rate for each form the attention kernels could use.

``tanh_probe`` launches the kernel for CUDA tensors and runs
``tanh_probe_reference`` for CPU tensors. On a CUDA tensor it never falls
back: the launch succeeds or it raises. ``tanh_rate`` runs the split forms'
per-pair work on values held in registers, without the stream of ce, so that
what the card's two tanh pipes sustain can be timed apart
(``tanh_rate_reference`` is its plain version).
"""

from __future__ import annotations

from typing import Optional

import torch

from show_and_tell_tpu_torch.ops import cuda_lib

# the kernel's `Form`, in its order: the tanh of bf16 pairs (run as one
# special-function operation per half); one operation per tanh in fp32 (~2^-11
# relative error); 1 - 2 / (1 + 2^(2x log2 e)) from ex2.approx and rcp.approx
# (two operations, absolute error below 5e-7); the precise tanhf; and
# split<P>, the kernel's ring design (ce streamed through shared memory by
# bulk copies), with P of each 16-byte vector's 4 bf16 pairs by an odd
# polynomial on the FMA pipe (within one bf16 step of the correctly rounded
# tanh) and the rest as bf16x2
TANH_FORMS = ("bf16x2", "approx_f32", "ex2_rcp", "precise", "split0", "split1", "split2", "split3", "split4")
# the share of the elements whose tanh a split form runs as the polynomial
SPLIT_SHARE = {f"split{p}": p / 4 for p in range(5)}
BF16_ONLY = ("bf16x2", *SPLIT_SHARE)
# the form that meets the dtype's tolerance at the least cost (bf16: the
# fastest at the serving shape, B=256 K=3 L=196 D=512, on the H100 in
# chip_smoke.py phase 4)
DEFAULT_FORM = {torch.bfloat16: "split0", torch.float32: "ex2_rcp"}


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
    if form in BF16_ONLY and ce.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the {form} form takes bfloat16 inputs, got {ce.dtype}")
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


def tanh_rate_reference(x0: torch.Tensor, hp: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of ``tanh_rate``: x0 [n, 32] bf16, hp [8] bf16 -> out
    [n] fp32, out[i] = sum over ``iters`` steps of sum_j tanh(x[i, j]) after
    x[i, j] += hp[j % 8] in bf16 (the sum and its tanh rounded to bf16, the
    accumulation fp32)."""
    x = x0
    h = hp.repeat(4)
    out = torch.zeros(x0.shape[0], dtype=torch.float32, device=x0.device)
    for _ in range(iters):
        x = x + h
        out += torch.tanh(x).sum(dim=1, dtype=torch.float32)
    return out


def tanh_rate(x0: torch.Tensor, hp: torch.Tensor, iters: int, form: str) -> torch.Tensor:
    """The compute-only loop of split form ``form`` (a name of
    ``SPLIT_SHARE``): for CUDA tensors the kernel, one thread per row of x0
    [n, 32] bf16 (n a multiple of 256), counted under ``tanh_rate`` by form;
    for CPU tensors ``tanh_rate_reference``."""
    if form not in SPLIT_SHARE:
        raise ValueError(f"unknown split form {form!r}; options: {tuple(SPLIT_SHARE)}")
    if x0.dtype != torch.bfloat16 or hp.dtype != torch.bfloat16 or x0.dim() != 2 or x0.shape[1] != 32 \
            or hp.shape != (8,) or x0.shape[0] % 256 or iters < 0:
        raise ValueError(f"tanh_rate: x0 {tuple(x0.shape)} {x0.dtype} must be [n, 32] bf16 with n a multiple "
                         f"of 256, hp {tuple(hp.shape)} {hp.dtype} [8] bf16, iters >= 0")
    if not x0.is_cuda:
        return tanh_rate_reference(x0, hp, iters)
    name = "tanh_rate"
    cuda_lib.check_operands(name, x0.device, x0=x0, hp=hp)
    if not cuda_lib.vectorizable((32,), x0, hp):
        raise ValueError(f"{name}: x0 and hp must be 16-byte aligned")
    out = torch.empty(x0.shape[0], dtype=torch.float32, device=x0.device)
    if x0.shape[0] == 0:
        return out
    err = cuda_lib.library("tanh_probe.cu").sat_tanh_rate(
        cuda_lib.ptr(x0), cuda_lib.ptr(hp), cuda_lib.ptr(out), x0.shape[0], iters, TANH_FORMS.index(form),
        cuda_lib.stream(x0.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.count(name, form)
    return out
