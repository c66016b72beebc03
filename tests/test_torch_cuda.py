"""PyTorch port on the card: the CUDA MDCT/IMDCT kernels against their plain
versions (TF32 off) at the tests/test_mdct_pallas.py geometries, and the
wrappers' checks. Skips without CUDA. Runs on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have). Tolerance: rtol 1e-4 / atol 1e-3, the transform contract.
"""

import pytest
import torch

from meanflow_audio_codec_torch.ops import imdct_cuda as imdct_cuda_mod
from meanflow_audio_codec_torch.ops import mdct_cuda as mdct_cuda_mod
from meanflow_audio_codec_torch.ops.imdct_cuda import imdct_cuda
from meanflow_audio_codec_torch.ops.mdct import (
    MDCTConfig,
    imdct,
    mdct,
    num_frames_for_length,
)
from meanflow_audio_codec_torch.ops.mdct_cuda import mdct_cuda

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-4, 1e-3
GEOMETRIES = [
    (8, 48000, 576, 288),
    (3, 10000, 256, 128),
    (2, 5000, 576, 100),
    (1, 2000, 128, 64),
    (5, 300, 512, 256),     # shorter than W: one zero-padded frame
    (8, 32768, 512, 256),   # the codec shape
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,length,window,hop", GEOMETRIES)
def test_mdct_kernel_matches_plain(device, rows, length, window, hop):
    x = torch.randn(rows, length, device=device,
                    generator=torch.Generator(device).manual_seed(rows))
    cfg = MDCTConfig(window, hop)
    before = mdct_cuda_mod.launches
    got = mdct_cuda(x, cfg)
    torch.cuda.synchronize()
    assert mdct_cuda_mod.launches == before + 1
    torch.testing.assert_close(got, mdct(x, cfg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("rows,length,window,hop", GEOMETRIES)
def test_imdct_kernel_matches_plain(device, rows, length, window, hop,
                                    normalize):
    nf = num_frames_for_length(length, window, hop)
    X = torch.randn(rows, nf, window, device=device,
                    generator=torch.Generator(device).manual_seed(hop))
    cfg = MDCTConfig(window, hop, normalize)
    before = imdct_cuda_mod.launches
    got = imdct_cuda(X, cfg)
    torch.cuda.synchronize()
    assert imdct_cuda_mod.launches == before + 1
    torch.testing.assert_close(got, imdct(X, cfg), rtol=RTOL, atol=ATOL)


def test_imdct_kernel_is_bitwise_stable(device):
    X = torch.randn(4, 127, 512, device=device)
    cfg = MDCTConfig(512)
    assert torch.equal(imdct_cuda(X, cfg), imdct_cuda(X, cfg))


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    cfg = MDCTConfig(64)
    with pytest.raises(TypeError):
        mdct_cuda(torch.zeros(2, 1000, device=device, dtype=torch.bfloat16),
                  cfg)
    with pytest.raises(ValueError):
        mdct_cuda(torch.zeros(1000, 2, device=device).t(), cfg)
    with pytest.raises(TypeError):
        imdct_cuda(torch.zeros(2, 5, 64, device=device, dtype=torch.float16),
                   cfg)
    with pytest.raises(ValueError):
        imdct_cuda(torch.zeros(2, 5, 32, device=device), cfg)
    with pytest.raises(ValueError):
        mdct_cuda(torch.zeros(2, 1000, device=device), MDCTConfig(64, 80))


def test_wrappers_raise_when_a_block_does_not_fit_shared_memory(device):
    # 31 hops + 2W of span at W = hop = 2048 and 15 frames of W = 4096 at
    # hop 1024 both exceed the 227 KiB a Hopper block may have
    with pytest.raises(ValueError, match="shared memory"):
        mdct_cuda(torch.zeros(1, 8192, device=device), MDCTConfig(2048, 2048))
    with pytest.raises(ValueError, match="shared memory"):
        imdct_cuda(torch.zeros(1, 2, 4096, device=device),
                   MDCTConfig(4096, 1024))
