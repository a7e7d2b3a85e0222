"""The reference's bf16 x bf16 -> f32 contractions: `jnp.dot` and
`jnp.einsum` with `preferred_element_type=jnp.float32` on operands in the
compute dtype (visdial_tpu/ops/lstm_pallas.py::_layer_bwd_kernel_path's dW
and dx, ops/lm_loss.py::_token_logprobs_bwd's dx and dW, models/core.py::
linear, models/decoders.py::disc_scores(_from_table), infer.py's
serve_disc).

Two forms: `mm_f32(a, b)`, a (..., K) times b (K, N), and `scores_f32(q,
e)`, q (N, H) against e (N, K, H), each with a float32 result.

- On a CUDA tensor in bfloat16: one cuBLAS GEMM on the tensor cores with
  bf16 operands, f32 accumulation and an f32 output (`torch.mm` / `torch.bmm`
  with `out_dtype=torch.float32`, aten::mm.dtype / bmm.dtype).  A torch
  without that overload raises; the card never takes the upcast route.
  `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` does
  not apply: it lets cuBLAS reduce split-K partial sums in the output type
  of a GEMM whose output is bf16, and here the output (and cuBLAS's compute
  type) is f32.
- On a CPU tensor, or in float32: the upcast product a.float() @ b.float()
  (the einsum of two upcasts for `scores_f32`), the port's expression
  before this route existed.  A product of two bf16 values is exact in f32,
  so the two routes differ only in the order of the f32 sums.

aten::mm.dtype and bmm.dtype have no derivative, so on the tensor-core
route one autograd Function carries the gradient JAX's autodiff of such a
dot takes: the f32 cotangent times the other operand upcast to f32, cast
to the operand's dtype (what autograd of the upcast product computes, so gradients do not
change with the route).

`mm_f32.tensor_core` and `scores_f32.tensor_core` count the calls that took
the tensor-core route (a check that a bf16 path on the card reached it).
"""

from __future__ import annotations

import torch


def _tensor_core(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a contraction of a and b takes the bf16 tensor-core route."""
    if a.dtype != b.dtype:
        raise TypeError(f"contraction operands differ in dtype: {a.dtype} and "
                        f"{b.dtype}")
    if a.device.type != "cuda":
        return False
    if a.dtype == torch.float32:
        return False
    if a.dtype != torch.bfloat16:
        raise TypeError(f"no f32-output contraction for {a.dtype} on the card")
    return True


class _ContractF32(torch.autograd.Function):
    """a (M, K) @ b (K, N), or batched a (B, M, K) @ b (B, K, N), bf16 ->
    f32 on the tensor cores."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        gemm = torch.mm if a.dim() == 2 else torch.bmm
        return gemm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = (g @ b.float().mT).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = (a.float().mT @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) -> (..., N) float32, a and b in one compute
    dtype (float32 or bfloat16)."""
    if not _tensor_core(a, b):
        return a.float() @ b.float()
    mm_f32.tensor_core += 1
    y = _ContractF32.apply(a.reshape(-1, a.shape[-1]), b)
    return y.reshape(*a.shape[:-1], b.shape[-1])


mm_f32.tensor_core = 0


def scores_f32(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """score[n, k] = dot(q[n], e[n, k]): q (N, H), e (N, K, H) in one compute
    dtype -> (N, K) float32."""
    if not _tensor_core(q, e):
        return torch.einsum("nh,nkh->nk", q.float(), e.float())
    scores_f32.tensor_core += 1
    return _ContractF32.apply(e, q[:, :, None])[..., 0]


scores_f32.tensor_core = 0
