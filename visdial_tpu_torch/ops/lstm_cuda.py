"""Kernels K1 and K2: one masked LSTM layer forward and backward on Hopper
(csrc/lstm_fwd.cu, csrc/lstm_bwd.cu), and LSTMLayerFn, the autograd
Function that joins them.

Counterparts of visdial_tpu/ops/lstm_pallas.py::lstm_layer_pallas,
lstm_layer_bwd_pallas and the custom-vjp `_layer` (_layer_fwd,
_layer_bwd_kernel_path).  A CUDA tensor launches the kernel (or the call
raises); a CPU tensor takes the plain version (ops/lstm.py::
lstm_layer_plain, lstm_layer_bwd_plain).

One divergence from the JAX package: it engages its backward kernel only
for bf16 on a TPU (_use_bwd_kernel) and otherwise differentiates with the
XLA backward _layer_bwd; the math is the same.  Here LSTMLayerFn takes K2
on CUDA for both float32 and bfloat16.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .contract import mm_f32
from .lstm import lstm_layer_bwd_plain, lstm_layer_plain


def k_tile(dtype: torch.dtype) -> int:
    """Depth of the kernels' k-tiles: 128 bytes of the compute dtype."""
    return 128 // torch.empty((), dtype=dtype).element_size()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_input(x: torch.Tensor) -> torch.Tensor:
    """x (N, T, E) with E zero-padded to a multiple of 8, so that rows start
    16 bytes apart (what the kernels' 16-byte copies take)."""
    E = x.shape[-1]
    pad = _round_up(E, 8) - E
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def pack_weights(w: torch.Tensor, E: int, dtype: torch.dtype):
    """The gate product's B operand from W (E+H, 4H), in `dtype`, K-major:
    wk (4H, KW), row 4j + g of which is gate column g*H + j of W
    (gate-interleaved, so a tile of 4u rows holds all four gates of u
    units); columns [0, E) hold W's x rows, zero-padded to Kx = E rounded up
    to a k-tile, then W's h rows from Kx, zero-padded to KW = Kx + H rounded
    up.  (K2's dh product takes W[E:] as it is stored.)  Returns (wk, Kx,
    KW)."""
    H = w.shape[1] // 4
    bk = k_tile(dtype)
    kx, kh = _round_up(E, bk), _round_up(H, bk)
    w = w.to(dtype)
    wt = w.T.reshape(4, H, E + H).transpose(0, 1).reshape(4 * H, E + H)
    wk = w.new_zeros(4 * H, kx + kh)
    wk[:, :E] = wt[:, :E]
    wk[:, kx:kx + H] = wt[:, E:]
    return wk, kx, kx + kh


# The tiles of K1 and of both phases of K2, narrowest first: (rows, gate
# columns, blocks an SM holds at once).  The last follows from the shared
# memory a block takes (common.cuh::TileSmem: 65, 129 and 193 KB in bf16,
# 81 and 161 KB in f32) against the 228 KB of a Hopper SM, the only card the
# kernels are built for; f32 has no 256-row tile (csrc/lstm_fwd.cu).
TILES = {torch.bfloat16: ((64, 64, 3), (128, 128, 1), (256, 128, 1)),
         torch.float32: ((64, 64, 2), (128, 128, 1))}
# the K-splits of K2's dh phase, fewest first
DH_SPLITS = (1, 2, 4, 8)


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _waves(blocks: int, tile: tuple[int, int, int], sms: int) -> int:
    return -(-blocks // (sms * tile[2]))


def lstm_tile(N: int, H: int, dtype: torch.dtype,
              sms: int) -> tuple[int, int, int]:
    """The tile (BM, BN, blocks an SM holds) of K1 and K2 for N rows of H
    units on `sms` SMs: the one whose grid of (4H / BN) x (N / BM) blocks
    runs in the fewest waves, and the narrowest of those.  A step launch
    costs about one block's time a wave, which grows with the tile (13, 18
    and 28 µs for 64, 128 and 256 rows at E 300 in bf16 on an H100;
    PERF.md), so a wider tile pays only where it saves a wave: 640 rows
    take the 64 x 64 tile (320 blocks, one wave), 1,696 rows the 256 x 128
    (112 blocks)."""
    return min(TILES[dtype], key=lambda t: _waves(
        -(-4 * H // t[1]) * -(-N // t[0]), t, sms))


def dh_splits(N: int, H: int, dtype: torch.dtype, tile: tuple[int, int, int],
              sms: int) -> int:
    """S, the slices of K2's dh phase over K = 4H on `tile`: the most (of
    DH_SPLITS, each slice holding a k-tile) whose grid of (H / BN) x
    (N / BM) x S blocks still runs in one wave; 1 where none does.  More
    slices shorten each block's k-loop, but each adds an (N, H) f32 buffer
    that the gates phase reads at every step, and a grid past one wave
    waits for a second (PERF.md)."""
    blocks = -(-H // tile[1]) * -(-N // tile[0])
    nkt = -(-4 * H // k_tile(dtype))
    fits = [s for s in DH_SPLITS
            if s <= nkt and _waves(blocks * s, tile, sms) == 1]
    return fits[-1] if fits else 1


# K1's resident route (csrc/lstm_fwd.cu): a cluster of ceil(H / 32) blocks
# owns R rows (one of RESIDENT_ROWS) for all T steps, W_h in the registers
# of its blocks and W_x's slice in their shared memory.  Whether a layer
# fits, and the ring of x k-tiles beside it, the C side decides.
RESIDENT_ROWS = (16, 32, 48, 64)
ROUTES = ("resident", "step")


@functools.cache
def resident_clusters(index: int, Kx: int, H: int, T: int) -> int:
    """How many of the resident route's clusters CUDA device `index` runs at
    once for a bf16 layer of T steps, Kx (its input width padded to a
    k-tile) and H units (cudaOccupancyMaxActiveClusters); 0 where the layer
    does not fit the resident kernel (H past 512; W_x's slice too wide).
    Read once a device and shape."""
    lib = _build.library()
    with torch.cuda.device(index):
        n = lib.vd_lstm_resident_clusters(Kx, H, T)
    if n < 0:
        _build.check(-n, "resident_clusters")
    return n


def layer_plan(N: int, H: int, dtype: torch.dtype, clusters: int,
               sms: int) -> tuple[str, int]:
    """K1's route for N rows of H units and what its launch takes last,
    where the card runs `clusters` resident clusters at once for the layer
    (resident_clusters; 0 where it does not fit) and has `sms` SMs:
    ("resident", R) in bf16 where ceil(N / 64) clusters run in one wave, so
    that none waits for another to finish, with R the fewest rows a cluster
    (of RESIDENT_ROWS) that still need no more clusters than that, so that
    the rows, products and cell updates spread over every cluster that runs
    (320 rows on 7 clusters take 48); else ("step", BM), one launch a step
    on lstm_tile's tile.  At a few hundred rows a step launch re-streams all
    of W for ~1 GFLOP of work; at tens of thousands every SM wants rows of
    its own (PERF.md)."""
    if dtype == torch.bfloat16 and -(-N // RESIDENT_ROWS[-1]) <= clusters:
        return "resident", next(r for r in RESIDENT_ROWS if -(-N // r) <= clusters)
    return "step", lstm_tile(N, H, dtype, sms)[0]


def _count(wrapper, attr: str) -> None:
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def _check_layer(what: str, w, b, x, mask, h0, c0) -> tuple[int, int, int, int]:
    """Validate what K1 and K2 take; returns (N, T, E, H)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (N, T, E) tensor, "
                         f"got shape {tuple(x.shape)}")
    N, T, E = x.shape
    H = w.shape[1] // 4
    if T < 1 or N < 1:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")
    if tuple(w.shape) != (E + H, 4 * H) or tuple(b.shape) != (4 * H,):
        raise ValueError(f"{what}: w {tuple(w.shape)} / b {tuple(b.shape)} "
                         f"do not fit E={E}, H={H}")
    if tuple(mask.shape) != (N, T):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} != {(N, T)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if (tuple(s.shape) != (N, H) or s.dtype != torch.float32
                or not s.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{(N, H)}, got {s.dtype} {tuple(s.shape)}")
    for t in (mask, w, b, h0, c0):
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
    return N, T, E, H


def lstm_layer(w, b, x, mask, h0, c0, *, save_cell: bool = False):
    """One masked LSTM layer (K1).  w (E+H, 4H) packed [x; h] (cast to
    x.dtype, as the TPU wrapper does), b (4H,), x (N, T, E) float32 or
    bfloat16, mask (N, T), h0/c0 (N, H) float32.  Returns hs (N, T, H) in
    x.dtype and (hT, cT) (N, H) in float32; with save_cell (hs, cs, hT, cT),
    cs the post-mask cell state of every step in x.dtype (the training
    forward's residual; without it the kernel writes none).
    `lstm_layer.launches` counts the calls that went to the kernel,
    `.route_resident` and `.route_step` those on each route (layer_plan),
    and `.tile_64`, `.tile_128`, `.tile_256` the step route's on each tile
    (lstm_tile)."""
    if x.device.type == "cpu":
        return lstm_layer_plain(w, b, x, mask, h0, c0, save_cell=save_cell)
    N, T, E, H = _check_layer("lstm_layer", w, b, x, mask, h0, c0)
    wk, kx, kw = pack_weights(w, E, x.dtype)
    xp = pad_input(x)
    b = b.float().contiguous()
    mask = mask.float().contiguous()
    hs = torch.empty((N, T, H), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(hs) if save_cell else None
    h0c = h0.to(x.dtype).contiguous()
    h, c = h0.clone(), c0.clone()      # the carries: (h0, c0) in, (hT, cT) out
    index = x.device.index
    clusters = (resident_clusters(index, kx, H, T)
                if x.dtype == torch.bfloat16 else 0)
    route, last = layer_plan(N, H, x.dtype, clusters, sm_count(index))
    lib = _build.library()
    launch = (lib.vd_lstm_layer_fwd_resident if route == "resident"
              else lib.vd_lstm_layer_fwd)
    with torch.cuda.device(x.device):
        err = launch(
            _build.DTYPE_CODE[x.dtype], xp.data_ptr(), mask.data_ptr(),
            wk.data_ptr(), b.data_ptr(), h0c.data_ptr(), h.data_ptr(),
            c.data_ptr(), hs.data_ptr(), cs.data_ptr() if save_cell else None,
            N, T, xp.shape[-1], kx, kw, H, last, _build.stream_of(x))
    _build.check(err, "lstm_layer")
    lstm_layer.launches += 1
    _count(lstm_layer, f"route_{route}")
    if route == "step":
        _count(lstm_layer, f"tile_{last}")
    if save_cell:
        return hs, cs, h, c
    return hs, h, c


lstm_layer.launches = 0


def lstm_layer_bwd(w, b, x, mask, h_prev, c_prev, g_hs, g_ht, g_ct):
    """One masked LSTM layer backward (K2), the twin of
    lstm_layer_bwd_pallas.  x, h_prev, c_prev and g_hs (N, T, ·) share the
    compute dtype (float32 or bfloat16); h_prev / c_prev hold the state
    that fed each step ([h0; hs[:, :-1]], [c0; cs[:, :-1]]); g_ht, g_ct
    (N, H).  Returns dgp (N, T, 4H) in the compute dtype (the gate
    pre-activation grads), dh0 and dc0 (N, H) float32.
    `lstm_layer_bwd.launches` counts the calls that went to the kernel,
    `.tile_64`, `.tile_128`, `.tile_256` those on each tile and
    `.dh_split_1` ... `.dh_split_8` those at each S (lstm_tile,
    dh_splits)."""
    if x.device.type == "cpu":
        return lstm_layer_bwd_plain(w, b, x, mask, h_prev, c_prev, g_hs, g_ht,
                                    g_ct)
    dh = g_ht.float().contiguous().clone()   # the carries: (g_hT, g_cT) in,
    dc = g_ct.float().contiguous().clone()   # (dh0, dc0) out
    N, T, E, H = _check_layer("lstm_layer_bwd", w, b, x, mask, dh, dc)
    for name, s in (("h_prev", h_prev), ("c_prev", c_prev), ("g_hs", g_hs)):
        if (tuple(s.shape) != (N, T, H) or s.dtype != x.dtype
                or not s.is_contiguous() or s.device != x.device):
            raise ValueError(f"lstm_layer_bwd: {name} must be a contiguous "
                             f"{x.dtype} {(N, T, H)} on {x.device}, got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")
    wk, kx, kw = pack_weights(w, E, x.dtype)
    wh = w.to(x.dtype)[E:].contiguous()
    xp = pad_input(x)
    b = b.float().contiguous()
    mask = mask.float().contiguous()
    dgp = torch.empty((N, T, 4 * H), dtype=x.dtype, device=x.device)
    sms = sm_count(x.device.index)
    tile = lstm_tile(N, H, x.dtype, sms)
    # K2's dh product is cut over K into S slices, each writing its partial
    # product to its own buffer
    S = dh_splits(N, H, x.dtype, tile, sms)
    dhp = torch.zeros((S, N, H), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lstm_layer_bwd(
            _build.DTYPE_CODE[x.dtype], xp.data_ptr(), h_prev.data_ptr(),
            c_prev.data_ptr(), mask.data_ptr(), wk.data_ptr(), wh.data_ptr(),
            b.data_ptr(), g_hs.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            dhp.data_ptr(), dgp.data_ptr(), N, T, xp.shape[-1], kx, kw, H,
            S, tile[0], _build.stream_of(x))
    _build.check(err, "lstm_layer_bwd")
    lstm_layer_bwd.launches += 1
    _count(lstm_layer_bwd, f"tile_{tile[0]}")
    _count(lstm_layer_bwd, f"dh_split_{S}")
    return dgp, dh + dhp.sum(dim=0), dc


lstm_layer_bwd.launches = 0


def choice_counters() -> list[tuple[str, object, str]]:
    """(name, wrapper, attribute) of the counts of K1's routes, K1's and
    K2's tiles and K2's dh splits, which parallel/graph.py::counters() lists
    beside the launches."""
    rows = sorted({t[0] for tiles in TILES.values() for t in tiles})
    routes = [(f"lstm_layer.route_{r}", lstm_layer, f"route_{r}")
              for r in ROUTES]
    tiles = [(f"{fn.__name__}.tile_{bm}", fn, f"tile_{bm}")
             for fn in (lstm_layer, lstm_layer_bwd) for bm in rows]
    return routes + tiles + [(f"lstm_layer_bwd.dh_split_{s}", lstm_layer_bwd,
                              f"dh_split_{s}") for s in DH_SPLITS]


for _, _fn, _attr in choice_counters():
    setattr(_fn, _attr, 0)


class LSTMLayerFn(torch.autograd.Function):
    """One masked LSTM layer with a kernel backward (lstm_pallas.py::_layer
    with _layer_fwd and _layer_bwd_kernel_path).

    forward(w, b, x, mask, h0, c0) -> (hs, hT, cT) runs K1 saving the cell
    states.  backward runs K2 on the residuals, then the dW, db and dx
    contractions over all N*T rows as matmuls of compute-dtype operands
    with f32 results (ops/contract.py; the JAX package leaves them to XLA
    outside its kernel).  On CPU tensors both directions take the plain
    versions of K1 and K2."""

    @staticmethod
    def forward(ctx, w, b, x, mask, h0, c0):
        hs, cs, ht, ct = lstm_layer(w, b, x, mask, h0, c0, save_cell=True)
        ctx.save_for_backward(w, b, x, mask, h0, c0, hs, cs)
        return hs, ht, ct

    @staticmethod
    def backward(ctx, g_hs, g_ht, g_ct):
        w, b, x, mask, h0, c0, hs, cs = ctx.saved_tensors
        N, T, E = x.shape
        H = w.shape[1] // 4
        cdt = x.dtype
        # unused outputs arrive as zeros (materialized grads)
        h_prev = torch.cat([h0.to(cdt)[:, None], hs[:, :-1]], dim=1)
        c_prev = torch.cat([c0.to(cdt)[:, None], cs[:, :-1]], dim=1)
        dgp, dh0, dc0 = lstm_layer_bwd(w, b, x, mask, h_prev, c_prev,
                                       g_hs.to(cdt).contiguous(), g_ht, g_ct)
        # the reference's bf16 x bf16 -> f32 dots (ops/contract.py): dgp
        # stays in the compute dtype, with no f32 copy of it
        dgp_flat = dgp.reshape(N * T, 4 * H)
        dwx = mm_f32(x.reshape(N * T, E).T, dgp_flat)
        dwh = mm_f32(h_prev.reshape(N * T, H).T, dgp_flat)
        dw = torch.cat([dwx, dwh], dim=0).to(w.dtype)
        db = dgp_flat.sum(dim=0, dtype=torch.float32).to(b.dtype)
        dx = mm_f32(dgp_flat, w[:E].to(cdt).T).reshape(N, T, E).to(cdt)
        return dw, db, dx, None, dh0.to(h0.dtype), dc0.to(c0.dtype)
