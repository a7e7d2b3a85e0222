"""The port's CUDA kernels against their plain versions on the GPU, at
ragged shapes the serving shapes do not reach (row, unit and depth counts
that are not multiples of the kernels' tiles), plus the wrappers' checks.

Needs an NVIDIA GPU: every test skips without one.  On the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from visdial_tpu_torch.ops.attention import attention_fusion_ref
from visdial_tpu_torch.ops.attention_cuda import attention_fusion
from visdial_tpu_torch.ops.lstm import lstm_layer_plain
from visdial_tpu_torch.ops.lstm_cuda import lstm_layer

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,E,H", [(5, 7, 10, 12), (70, 3, 33, 40),
                                     (600, 5, 20, 36)])
def test_lstm_kernel_matches_plain(dev, N, T, E, H, dtype):
    g = torch.Generator().manual_seed(N)
    w = torch.empty(E + H, 4 * H).uniform_(-0.5, 0.5, generator=g)
    b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=g)
    x = torch.randn(N, T, E, generator=g).to(dtype)
    mask = (torch.rand(N, T, generator=g) < 0.6).float()
    mask[::3] = 0.0                                  # all-pad rows
    h0, c0 = torch.randn(2, N, H, generator=g)
    args = [t.to(dev) for t in (w, b, x, mask, h0, c0)]
    before = lstm_layer.launches
    got = lstm_layer(*args)
    want = lstm_layer_plain(*args)
    torch.cuda.synchronize()
    assert lstm_layer.launches == before + 1
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert float((a.float() - r.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,R,S,H", [(3, 4, 4, 16), (9, 5, 7, 24), (2, 3, 5, 100),
                                     (2, 3, 64, 40)])
def test_attention_kernel_matches_plain(dev, B, R, S, H, dtype):
    g = torch.Generator().manual_seed(B * S)
    q = torch.randn(B, R, H, generator=g)
    s = torch.randn(B, S, H, generator=g)
    valid = (torch.rand(B, R, S, generator=g) < 0.5).float()
    valid[0, 0] = 0.0                                # a fully masked row
    fw = torch.empty(2 * H, H).uniform_(-0.3, 0.3, generator=g)
    fb = torch.empty(H).uniform_(-0.3, 0.3, generator=g)
    args = [q.to(dev, dtype), s.to(dev, dtype), valid.to(dev), fw.to(dev),
            fb.to(dev)]
    got = attention_fusion(*args)
    want = attention_fusion_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 3, 8, device=dev)
    w, b = torch.zeros(8 + 6, 24, device=dev), torch.zeros(24, device=dev)
    h = torch.zeros(4, 6, device=dev)
    mask = torch.ones(4, 3, device=dev)
    with pytest.raises(TypeError):
        lstm_layer(w, b, x.half(), mask, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_layer(w, b, x.transpose(0, 1).contiguous().transpose(0, 1),
                   mask, h, h)
    q = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="S <= 64"):
        attention_fusion(q, torch.zeros(1, 65, 8, device=dev),
                         torch.ones(1, 2, 65, device=dev),
                         torch.zeros(16, 8, device=dev),
                         torch.zeros(8, device=dev))
