"""Kernels K3 and K4 on Hopper (csrc/attention_fusion.cu): masked slot
attention alone (K3, the training path) and with the fusion tail (K4, the
eval path).

Counterparts of visdial_tpu/ops/attention_pallas.py::
masked_slot_attention_pallas (custom-vjp `_attention`) and
attention_fusion_pallas (forward only, as the eval path uses it).  A CUDA
tensor launches the kernel (or the call raises); a CPU tensor takes the
plain version, ops/attention.py::attention_plain / attention_fusion_ref.

K4 takes one of two routes (fusion_route): few rows run in one launch that
streams Wf (2H, H) as it is, spread over the card; many rows run the
attention (K3's kernel, into a scratch buffer for mem) and then the fusion
product on the tensor cores, whose operands are K-major, so the call packs
Wf^T first (pack_fusion_weight).
"""

from __future__ import annotations

import contextlib

import torch

from . import _build
from .attention import attention_fusion_ref, attention_plain
from .lstm_cuda import k_tile

MAX_SLOTS = 64
# K4 streams Wf for calls of at most this many rows (B * R) and runs on the
# tensor cores above it: where the two routes' device times cross, by dtype
# (`scripts/attention_check.py --sweep` on an H100; PERF.md)
FUSION_STREAM_ROWS = {torch.float32: 40, torch.bfloat16: 20}
ROUTE_CODE = {"stream": 0, "tiles": 1}
FILL_BLOCKS = 128    # blocks that fill the H100's 132 SMs
# csrc/attention_fusion.cu's kMaxCluster, kStreamCols and kTileM (= kTileN),
# which the rules below read
MAX_CLUSTER = 8      # the portable thread-block cluster size
STREAM_COLS = 32     # K4's few-rows output columns a cluster
TILE = 64            # K4's tensor-core output tiles


def fill_split(blocks: int, most: int, fill: int = FILL_BLOCKS) -> int:
    """Blocks a cluster for a launch of `blocks` clusters: the smallest power
    of two n <= MAX_CLUSTER with blocks x n >= fill, and 2n <= `most` (the
    pieces there are to split)."""
    n = 1
    while n < MAX_CLUSTER and blocks * n < fill and 2 * n <= most:
        n *= 2
    return n


def _chunks(H: int, dtype: torch.dtype) -> int:
    """16-byte chunks of a row of H values of dtype."""
    return -(-H // (8 if dtype == torch.bfloat16 else 4))


def attention_blocks(B: int, H: int, dtype: torch.dtype) -> int:
    """K3's blocks a dialog (a cluster that splits H), also K4's attention on
    its tensor-core route: 2 x FILL_BLOCKS blocks in all, as a block takes
    ~12 KB of shared memory at S = 10 and several share an SM (8 at 32
    dialogs; `scripts/attention_check.py --clusters`)."""
    return fill_split(B, _chunks(H, dtype), 2 * FILL_BLOCKS)


def stream_blocks(H: int, dtype: torch.dtype) -> int:
    """Blocks a cluster on K4's few-rows route, each cluster STREAM_COLS
    output columns (8 at H = 512: 128 blocks)."""
    return fill_split(-(-H // STREAM_COLS), _chunks(H, dtype))


def fusion_splits(M: int, H: int, dtype: torch.dtype) -> int:
    """k-slices (blocks a cluster) of K4's tensor-core product at M rows: 4
    in f32 at 320 rows (two blocks an SM; eight measured slower), 8 in bf16
    (four an SM)."""
    tiles = -(-M // TILE) * -(-H // TILE)
    fill = 2 * FILL_BLOCKS if dtype == torch.bfloat16 else FILL_BLOCKS
    return fill_split(tiles, 2 * -(-H // k_tile(dtype)), fill)


def stream_fits(B: int, R: int, S: int, H: int, dtype: torch.dtype) -> bool:
    """Whether K4's few-rows launch fits a block's shared memory at this
    shape: the library sizes it (vd_fusion_stream_fits)."""
    return bool(_build.library().vd_fusion_stream_fits(
        _build.DTYPE_CODE[dtype], B, R, S, H, stream_blocks(H, dtype)))


def fusion_route(B: int, R: int, S: int, H: int, dtype: torch.dtype) -> str:
    """K4's route for a call of B dialogs x R rounds over S slots: "stream"
    (one launch, CUDA cores, Wf read once) up to FUSION_STREAM_ROWS[dtype]
    rows where its shared memory fits, else "tiles" (the attention, then
    common.cuh::tile_product on the tensor cores, Wf packed)."""
    if B * R <= FUSION_STREAM_ROWS[dtype] and stream_fits(B, R, S, H, dtype):
        return "stream"
    return "tiles"


def pack_fusion_weight(fusion_w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tensor-core route's B operand from Wf (2H, H): Wf^T in `dtype`, a
    contiguous (H, 2 Hp) tensor with wk[j, k] = Wf[k, j] and wk[j, Hp + k] =
    Wf[H + k, j] for k < H and zeros elsewhere, Hp being H rounded up to a
    whole k-tile (k_tile(dtype) values, 128 bytes), so that the q half and
    the mem half each start a k-tile."""
    H = fusion_w.shape[1]
    Hp = -(-H // k_tile(dtype)) * k_tile(dtype)
    new = fusion_w.new_empty if Hp == H else fusion_w.new_zeros
    wk = new((H, 2, Hp), dtype=dtype)
    wk[:, :, :H] = fusion_w.reshape(2, H, H).permute(2, 0, 1)   # (j, half, k)
    return wk.view(H, 2 * Hp)


def _check(what: str, query, slots, valid, *others) -> tuple[int, int, int, int]:
    """Validate what K3 and K4 take; returns (B, R, S, H)."""
    if query.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {query.device}")
    dt = query.dtype
    if dt not in _build.DTYPE_CODE or slots.dtype != dt:
        raise TypeError(f"{what}: query/slots must share float32 or "
                        f"bfloat16, got {dt}/{slots.dtype}")
    if query.dim() != 3 or slots.dim() != 3:
        raise ValueError(f"{what}: query and slots must be 3-D")
    B, R, H = query.shape
    S = slots.shape[1]
    if tuple(slots.shape) != (B, S, H) or not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"{what}: slots {tuple(slots.shape)} do not fit "
                         f"query {tuple(query.shape)} with 1 <= S <= {MAX_SLOTS}")
    if tuple(valid.shape) != (B, R, S):
        raise ValueError(f"{what}: valid {tuple(valid.shape)} != {(B, R, S)}")
    if not (query.is_contiguous() and slots.is_contiguous()):
        raise ValueError(f"{what}: query and slots must be contiguous")
    for t in (slots, valid, *others):
        if t.device != query.device:
            raise ValueError(f"{what}: operands on {t.device} and {query.device}")
    return B, R, S, H


def _mask(valid: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """valid as the kernels read it, f32 with unit slot stride, and its
    batch and row strides: an f32 view such as the encoder's expanded
    causal mask (batch stride 0) crosses as it is; another dtype is
    converted."""
    if valid.dtype != torch.float32:
        valid = valid.float()
    if valid.stride(2) != 1:
        valid = valid.contiguous()
    return valid, valid.stride(0), valid.stride(1)


def _on(device: torch.device):
    """torch.cuda.device(device), entered only where it is not current."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def masked_slot_attention(query, slots, valid):
    """Attention-weighted slot sum (K3): query (B, R, H) and slots (B, S, H)
    float32 or bfloat16, valid (B, R, S) 1.0 where slot s is visible to
    round r.  Returns (B, R, H) in query.dtype, f32 math inside.  Forward
    only; AttentionFn adds the gradient.  `masked_slot_attention.launches`
    counts the calls that went to the kernel."""
    if query.device.type == "cpu":
        return attention_plain(query, slots, valid)
    B, R, S, H = _check("masked_slot_attention", query, slots, valid)
    valid, vb, vr = _mask(valid)
    out = torch.empty_like(query)
    with _on(query.device):
        err = _build.library().vd_attention(
            _build.DTYPE_CODE[query.dtype], query.data_ptr(), slots.data_ptr(),
            valid.data_ptr(), vb, vr, out.data_ptr(), B, R, S, H,
            attention_blocks(B, H, query.dtype), _build.stream_of(query))
    _build.check(err, "masked_slot_attention")
    masked_slot_attention.launches += 1
    return out


masked_slot_attention.launches = 0


class AttentionFn(torch.autograd.Function):
    """K3 with a gradient (attention_pallas.py::_attention with
    _attention_fwd / _attention_bwd): the forward is the kernel; the backward
    recomputes the plain version and returns its vjp, as the JAX package
    does (K3 has no backward kernel there either).  valid gets no grad."""

    @staticmethod
    def forward(ctx, query, slots, valid):
        ctx.save_for_backward(query, slots, valid)
        return masked_slot_attention(query, slots, valid)

    @staticmethod
    def backward(ctx, g):
        query, slots, valid = ctx.saved_tensors
        with torch.enable_grad():
            q = query.detach().requires_grad_()
            s = slots.detach().requires_grad_()
            dq, ds = torch.autograd.grad(attention_plain(q, s, valid), (q, s), g)
        return dq, ds, None


def attention_fusion(query, slots, valid, fusion_w, fusion_b):
    """joint = tanh([query; attention(query, slots)] @ fusion_w + fusion_b)
    (K4).  query (B, R, H) and slots (B, S, H) float32 or bfloat16, valid
    (B, R, S), fusion_w (2H, H) (rounded to query.dtype inside, as the TPU
    wrapper casts it), fusion_b (H,).  Returns (B, R, H) in query.dtype.
    Forward only (the eval path).  `attention_fusion.launches` counts the
    calls that went to the kernel."""
    if query.device.type == "cpu":
        return attention_fusion_ref(query, slots, valid, fusion_w, fusion_b)
    B, R, S, H = _check("attention_fusion", query, slots, valid, fusion_w,
                        fusion_b)
    if tuple(fusion_w.shape) != (2 * H, H) or tuple(fusion_b.shape) != (H,):
        raise ValueError(f"attention_fusion: fusion_w {tuple(fusion_w.shape)}, "
                         f"fusion_b {tuple(fusion_b.shape)} do not fit H={H}")
    dt = query.dtype
    route = fusion_route(B, R, S, H, dt)
    if route == "tiles":
        w = pack_fusion_weight(fusion_w, dt)
        mem = torch.empty_like(query)
        cl, ks = attention_blocks(B, H, dt), fusion_splits(B * R, H, dt)
    else:
        w = fusion_w.float().contiguous()   # f32 Wf crosses as it is
        mem = query                         # not used
        cl, ks = stream_blocks(H, dt), 0    # ks is not used
    bias = fusion_b.float().contiguous()
    valid, vb, vr = _mask(valid)
    out = torch.empty_like(query)
    with _on(query.device):
        err = _build.library().vd_attention_fusion(
            _build.DTYPE_CODE[dt], ROUTE_CODE[route], query.data_ptr(),
            slots.data_ptr(), valid.data_ptr(), vb, vr, w.data_ptr(),
            bias.data_ptr(), mem.data_ptr(), out.data_ptr(), B, R, S, H, cl, ks,
            _build.stream_of(query))
    _build.check(err, "attention_fusion")
    attention_fusion.launches += 1
    return out


attention_fusion.launches = 0
