"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only ``torch`` and ``repro_torch``, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips. The full check at the main path's
shapes is ``chip_smoke.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,k", [(15, 103), (37, 300), (513, 190),
                                 (15, 1024)],
                         ids=["main_path", "any_width", "wide_d",
                              "two_tiles"])
def test_cuda_kernels_match_plain(d, k, dt):
    """Every kernel against its plain version, at the main path's d = 15
    (register rows, one center tile), at d = 37 and 513 (any width,
    several tiles) and at k = 1024 (two tiles). The tolerance is
    chip_smoke.py's: 32 float32 ulps of max ||x||^2 + max ||c||^2, the
    error of the expanded form in another summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    g = torch.Generator("cuda").manual_seed(0)
    n = 3000
    x = torch.rand((n, d), device="cuda", generator=g).to(dt)
    xf = x.float()
    c = torch.rand((k, d), device="cuda", generator=g)
    cv = torch.rand(k, device="cuda", generator=g) > 0.3
    cv[0] = True
    w = torch.rand(n, device="cuda", generator=g)
    tol = 32 * torch.finfo(torch.float32).eps * float(
        (xf * xf).sum(-1).max() + (c * c).sum(-1).max())

    d2, idx = ops.min_dist(x, c, cv)
    d2_p, _ = ref.min_dist_ref(x, c, cv)
    torch.testing.assert_close(d2, d2_p, rtol=0, atol=tol)
    ci = c[idx.long()]                   # argmin through the realized d2
    real = torch.clamp((xf * xf).sum(-1) - 2 * (xf * ci).sum(-1)
                       + (ci * ci).sum(-1), min=0)
    torch.testing.assert_close(real, d2_p, rtol=0, atol=2 * tol)
    assert bool(cv[idx.long()].all())

    # The other kernels share min_dist's distance code, so they assign
    # every point to the same center bit for bit: hold their reductions
    # to min_dist's own assignment.
    s, cnt, cost = ops.fused_assign_reduce(x, w, c, cv)
    cnt_p = torch.zeros(k, device="cuda").index_add_(0, idx.long(), w)
    s_p = torch.zeros((k, d), device="cuda").index_add_(0, idx.long(),
                                                        w[:, None] * xf)
    torch.testing.assert_close(cnt, cnt_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(cost, (w * d2).sum(), rtol=1e-5, atol=1e-5)

    u, mass = ops.update_min_dist(x, w, c, d2_p + 0.5, cv)
    u_p, mass_p = ref.update_min_dist_ref(x, w, c, d2_p + 0.5, cv)
    torch.testing.assert_close(u, u_p, rtol=0, atol=tol)
    torch.testing.assert_close(mass, mass_p, rtol=1e-5,
                               atol=tol * float(w.sum()))

    alive = torch.rand((3, n // 3), device="cuda", generator=g) > 0.1
    v = torch.median(d2)
    a, live = ops.remove_below(x.reshape(3, n // 3, d), c, alive, v, cv)
    assert torch.equal(a, alive & (d2.reshape(3, n // 3) > v))
    assert torch.equal(live, a.sum(1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,k", [(9, 1025), (33, 2100), (15, 110_000)],
                         ids=["k_over_max", "k_chunked_multi",
                              "two_walk_regime"])
def test_cuda_chunked_fused_matches_plain(d, k, dt):
    """The chunked Lloyd kernel (k > 1024) against its plain version, on
    both sides of the TPU kernel's 6 MiB accumulator split (110,000
    centers at d = 15 is 6.7 MiB). Its argmin is min_dist's, so the sums
    and counts are held to min_dist's own assignment; invalid centers get
    no mass, zero weights add nothing, and a second call gives the same
    bits (the sums are fixed-point integer additions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    g = torch.Generator("cuda").manual_seed(1)
    n = 3000
    x = torch.rand((n, d), device="cuda", generator=g).to(dt)
    xf = x.float()
    c = torch.rand((k, d), device="cuda", generator=g)
    cv = torch.rand(k, device="cuda", generator=g) > 0.3
    cv[0] = True
    w = torch.rand(n, device="cuda", generator=g)
    w[: n // 5] = 0.0
    before = ops.KERNELS["fused_assign_reduce_chunked"].launches
    s, cnt, cost = ops.fused_assign_reduce(x, w, c, cv)
    assert ops.KERNELS["fused_assign_reduce_chunked"].launches == before + 1
    d2, idx = ops.min_dist(x, c, cv)
    cnt_p = torch.zeros(k, device="cuda").index_add_(0, idx.long(), w)
    s_p = torch.zeros((k, d), device="cuda").index_add_(0, idx.long(),
                                                        w[:, None] * xf)
    torch.testing.assert_close(cnt, cnt_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(cost, (w * d2).sum(), rtol=1e-5, atol=1e-5)
    assert float(cnt[~cv].abs().sum()) == 0.0
    # the plain version: the same function, its d2 within the expanded
    # form's tolerance (see test_cuda_kernels_match_plain) at every point
    tol = 32 * torch.finfo(torch.float32).eps * float(
        (xf * xf).sum(-1).max() + (c * c).sum(-1).max())
    _, cnt_r, cost_r = ref.fused_assign_reduce_ref(x, w, c, cv)
    torch.testing.assert_close(cost, cost_r, rtol=1e-5,
                               atol=tol * float(w.sum()))
    torch.testing.assert_close(cnt.sum(), cnt_r.sum(), rtol=1e-5, atol=1e-3)
    again = ops.fused_assign_reduce(x, w, c, cv)
    assert all(torch.equal(a, b) for a, b in zip((s, cnt, cost), again))
    zero = ops.fused_assign_reduce(x, torch.zeros_like(w), c, cv)
    assert all(float(t.abs().max()) == 0.0 for t in zero)
