"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked ``gpu``: they skip without a CUDA device (the kernels have no
CPU mode).  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: relative inf-norm error 1e-4 in float32 (sums in another order,
atomics in no fixed order), 2e-2 with a bfloat16 x."""
import numpy as np
import pytest
import torch

from repro_torch.core import formats
from repro_torch.core.rmat import rmat
from repro_torch.kernels import csc, launch_counts, reset_launch_counts, spmv, vsr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _graphs(device):
    a = np.zeros((300, 90), np.float32)
    rng = np.random.default_rng(0)
    a[:40] = (rng.random((40, 90)) < 0.3) * rng.standard_normal((40, 90))
    a[250:] = (rng.random((50, 90)) < 0.3) * rng.standard_normal((50, 90))
    return {"skewed": rmat(9, 8, seed=3, device=device),
            "uniform": rmat(9, 8, 0.25, 0.25, 0.25, seed=4, device=device),
            "empty_band": formats.csr_from_dense(a, device=device)}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 20, 32, 64, 128, 200])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, n, xdtype):
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        x = torch.randn(csr.shape[1], n, device=cuda).to(xdtype)
        for tile in (32, 100, 512):
            bal = formats.csr_to_balanced(csr, tile)
            assert _rel(vsr.spmm_vsr_fused(bal, x), vsr.spmm_vsr_plain(bal, x)) < tol, name
            x1 = x[:, 0].contiguous()
            assert _rel(spmv.spmv_vsr_fused(bal, x1), spmv.spmv_vsr_plain(bal, x1)) < tol, name
        ell = formats.csr_to_ell(csr)
        assert _rel(csc.spmm_csc(ell, x), csc.spmm_csc_plain(ell, x)) < tol, name
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_bf16_values(cuda):
    csr = _graphs(cuda)["skewed"]
    csr = formats.CSR(csr.indptr, csr.indices, csr.data.bfloat16(), csr.shape)
    x = torch.randn(csr.shape[1], 16, device=cuda)
    bal, ell = formats.csr_to_balanced(csr, 256), formats.csr_to_ell(csr)
    assert _rel(vsr.spmm_vsr_fused(bal, x), vsr.spmm_vsr_plain(bal, x)) < 1e-4
    assert _rel(spmv.spmv_vsr_fused(bal, x[:, 0].contiguous()),
                spmv.spmv_vsr_plain(bal, x[:, 0].contiguous())) < 1e-4
    assert _rel(csc.spmm_csc(ell, x), csc.spmm_csc_plain(ell, x)) < 1e-4


@pytest.mark.gpu
def test_cuda_kernels_count_launches_and_reject(cuda):
    csr = _graphs(cuda)["skewed"]
    bal = formats.csr_to_balanced(csr, 64)
    reset_launch_counts()
    vsr.spmm_vsr_fused(bal, torch.randn(csr.shape[1], 8, device=cuda))
    spmv.spmv_vsr_fused(bal, torch.randn(csr.shape[1], device=cuda))
    csc.spmm_csc(formats.csr_to_ell(csr), torch.randn(csr.shape[1], 8, device=cuda))
    assert launch_counts() == {"vsr_spmm": 1, "vsr_spmv": 1, "csc_spmm": 1}
    with pytest.raises(ValueError):          # no float64 kernel
        vsr.spmm_vsr_fused(bal, torch.randn(csr.shape[1], 8, device=cuda,
                                            dtype=torch.float64))
    with pytest.raises(ValueError):          # strided x
        vsr.spmm_vsr_fused(bal, torch.randn(8, csr.shape[1], device=cuda).t())
    with pytest.raises(ValueError):          # over the shared-memory staging
        vsr.spmm_vsr_fused(formats.csr_to_balanced(csr, 8192),
                           torch.randn(csr.shape[1], 8, device=cuda))
    with pytest.raises(ValueError):          # operands on two devices
        vsr.spmm_vsr_fused(bal, torch.randn(csr.shape[1], 8))
    assert launch_counts() == {"vsr_spmm": 1, "vsr_spmv": 1, "csc_spmm": 1}


@pytest.mark.gpu
def test_cuda_facade_main_path(cuda):
    import repro_torch
    for name, csr in _graphs(cuda).items():
        for n in (1, 4, 32):
            x = torch.randn(csr.shape[1], n, device=cuda)
            x = x[:, 0].contiguous() if n == 1 else x
            A = repro_torch.sparse(csr, cache=False)
            assert A.backend == "hopper"
            reset_launch_counts()
            y = A @ x
            assert sum(launch_counts().values()) == 1
            assert _rel(y, A.matmul(x, backend="torch")) < 1e-4, (name, n)
