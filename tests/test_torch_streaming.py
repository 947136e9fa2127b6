"""Port parity: out-of-core streaming (``ops.streaming``) against the JAX
package.

Both packages run on the CPU in f64 on host sources made with numpy from a
seed. The port draws the JAX package's sketches and splits and folds its
keys as JAX does (``same_sketch``), so the streamed single-pass SVD's
co-range blocks are JAX's own. The JAX package zero-pads the last block
and the port does not: a zero row adds nothing to a Gram, a sketch or B,
so the two agree to rounding, held at 1e-10 of the largest singular value
(projectors 1e-9). Covered: blocks that do not divide n, one block,
``RowBlockSource``, a read-only ``np.memmap``, ``devices=``, the streamed
``PodI``/``DMDc`` through ``save_model``, and the per-pass log record.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu_torch as port
from _torch_parity import EPS, cpu_device, same_sketch  # noqa: F401
from corrla_rs_tpu.ops import streaming as jst
from corrla_rs_tpu_torch.ops import streaming as pst
from corrla_rs_tpu_torch.utils import checkpoint as pck

torch.set_num_threads(1)

RTOL = 1e-10


def _decaying(rng, n, m, power=2.0):
    u, _ = np.linalg.qr(rng.standard_normal((n, m)))
    v, _ = np.linalg.qr(rng.standard_normal((m, m)))
    s = np.arange(1, m + 1, dtype=np.float64) ** (-power)
    return (u * s[None, :]) @ v.T


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_svd(got, want, rank):
    (u1, s1, vt1), (u0, s0, vt0) = [[_np(t) for t in r] for r in (got, want)]
    assert u1.shape == u0.shape and vt1.shape == vt0.shape
    assert np.abs(s1 - s0).max() <= RTOL * s0[0]
    for a, b in ((u1, u0), (vt1.T, vt0.T)):
        assert np.abs(a[:, :rank] @ a[:, :rank].T
                      - b[:, :rank] @ b[:, :rank].T).max() <= 1e-9


@pytest.mark.parametrize("method,center", [("gram", False), ("gram", True),
                                           ("power", False)])
@pytest.mark.parametrize("n,block", [(301, 64), (300, 128), (300, 300),
                                     (300, 1000)])
def test_streamed_random_svd_matches_jax(same_sketch, rng, method, center,
                                         n, block):
    # blocks that do not divide n, that do, one block, one longer than n
    a = _decaying(rng, n, 24) + (0.3 if center else 0.0)
    kw = dict(key=3, block_rows=block, method=method, center=center)
    want = jst.streamed_random_svd(a, 8, 6, 8, **kw)
    got = pst.streamed_random_svd(a, 8, 6, 8, **kw)
    assert got[0].shape == (n, 8) and got[0].dtype == torch.float64
    _same_svd(got, want, 6)


def test_streamed_random_svd_sketch_only_and_f32(same_sketch, rng):
    # n_iter 0 skips the Gram pass; f32 sources stay f32 (f32 rounding)
    a = _decaying(rng, 257, 20)
    _same_svd(pst.streamed_random_svd(a, 5, 0, 6, key=1, block_rows=50),
              jst.streamed_random_svd(a, 5, 0, 6, key=1, block_rows=50), 4)
    a32 = a.astype(np.float32)
    got = pst.streamed_random_svd(a32, 5, 4, 6, key=1, block_rows=50)
    want = jst.streamed_random_svd(a32, 5, 4, 6, key=1, block_rows=50)
    assert got[1].dtype == torch.float32
    assert np.abs(_np(got[1]) - _np(want[1])).max() <= 1e-5 * _np(want[1])[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chol_qr_cols_ridge_fallback_matches_jax(cpu_device, dtype):
    # W's last columns lie in the null space of a rank-3 A: their diagonals
    # of W^T H are rounding, floored, and the normalized Gram + small ridge
    # is indefinite, so both packages take the large-ridge factor
    rng = np.random.default_rng(5)
    n, m, r, k = 400, 30, 3, 10
    a = rng.standard_normal((n, r)) @ rng.standard_normal((r, m))
    null = np.linalg.svd(a)[2][r:].T
    w = np.concatenate([rng.standard_normal((m, r)),
                        null @ rng.standard_normal((m - r, k - r))], 1)
    w = torch.as_tensor(w.astype(dtype))
    h = torch.as_tensor((a.T @ a).astype(dtype)) @ w
    # the round's relative floor and small ridge, equal in both packages
    floor_rel = eps_small = 1e-6 if dtype == np.float32 else 1e-14
    yty = w.mT @ h
    yty = 0.5 * (yty + yty.mT)
    diag = torch.diagonal(yty)
    d = torch.sqrt(torch.clamp_min(diag, floor_rel * diag.max()))
    g = yty / (d[:, None] * d[None, :]) + eps_small * torch.eye(k,
                                                                dtype=w.dtype)
    assert int(torch.linalg.cholesky_ex(g, upper=True).info) != 0, \
        "W does not force the large-ridge branch"
    assert not np.isfinite(np.asarray(jnp.linalg.cholesky(
        jnp.asarray(g.numpy()), upper=True))).all()

    got = _np(pst._chol_qr_cols(w, h))
    want = np.asarray(jst._chol_qr_cols(jnp.asarray(w.numpy()),
                                        jnp.asarray(h.numpy())))
    assert np.isfinite(got).all()
    # the null columns are rounding over the floored normalizer
    # sqrt(floor_rel max diag)
    tol = EPS[dtype] / np.sqrt(floor_rel) * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


def test_streamed_pca_matches_jax(same_sketch, rng):
    a = _decaying(rng, 400, 16) + rng.standard_normal(16)[None, :]
    s0, c0 = jst.streamed_pca(a, 5, key=7, block_rows=90)
    s1, c1 = pst.streamed_pca(a, 5, key=7, block_rows=90)
    assert s1.shape == (5, 1) and c1.shape == (5, 16)
    assert np.abs(_np(s1) - _np(s0)).max() <= RTOL * _np(s0)[0, 0]
    gap = 1 - np.abs(np.sum(_np(c1) * _np(c0), axis=1))
    assert gap.max() <= 1e-9
    # against the exact centered spectrum
    s_true = np.linalg.svd(a - a.mean(0), compute_uv=False)[:5]
    assert np.abs(_np(s1)[:, 0] - s_true).max() <= 1e-9 * s_true[0]


@pytest.mark.parametrize("n,block", [(257, 64), (257, 300)])
def test_streamed_single_pass_matches_jax(same_sketch, rng, n, block):
    # Psi's blocks are drawn at (ell, block_rows) from fold_in(k_psi, i)
    # and cut to the block's rows: the same numbers as JAX's padded blocks
    a = _decaying(rng, n, 20, power=3.0)
    want = jst.streamed_single_pass_svd(a, 4, 6, key=2, block_rows=block)
    got = pst.streamed_single_pass_svd(a, 4, 6, key=2, block_rows=block)
    _same_svd(got, want, 4)
    low = rng.standard_normal((n, 4)) @ rng.standard_normal((4, 18))
    u, s, vt = pst.streamed_single_pass_svd(low, 4, 6, key=2,
                                            block_rows=block)
    rec = _np(u) * _np(s)[None, :] @ _np(vt)
    assert np.linalg.norm(rec - low) / np.linalg.norm(low) < 1e-9


def test_streamed_single_pass_with_torch_draws(cpu_device, rng):
    # with the port's own generators both passes draw the same Psi blocks:
    # exact on low-rank data, reproducible, as good as the in-memory pass
    low = rng.standard_normal((517, 5)) @ rng.standard_normal((5, 30))
    u, s, vt = pst.streamed_single_pass_svd(low, 5, 6, key=4, block_rows=100)
    rec = _np(u) * _np(s)[None, :] @ _np(vt)
    assert np.linalg.norm(rec - low) / np.linalg.norm(low) < 1e-9
    again = pst.streamed_single_pass_svd(low, 5, 6, key=4, block_rows=100)
    assert torch.equal(again[1], s)
    a = _decaying(rng, 600, 60, power=1.0)
    s_true = np.linalg.svd(a, compute_uv=False)[:10]
    err = [np.abs(_np(r[1]) - s_true).max() / s_true[0] for r in (
        pst.streamed_single_pass_svd(a, 10, 10, key=1, block_rows=128),
        port.single_pass_svd(a, 10, 10, key=1))]
    assert err[0] <= 3 * err[1] + 1e-3


def test_streamed_gram_cov_pearson_match_jax(cpu_device, rng):
    a = rng.standard_normal((523, 12)) @ rng.standard_normal((12, 12)) + 2.0
    g0, s0, n0 = jst.streamed_gram(a, block_rows=100)
    g1, s1, n1 = pst.streamed_gram(a, block_rows=100)
    assert n1 == n0 == 523
    assert np.abs(_np(g1) - np.asarray(g0)).max() <= 1e-12 * np.abs(g0).max()
    assert np.abs(_np(s1) - np.asarray(s0)).max() <= 1e-12 * np.abs(s0).max()
    cov = pst.streamed_cov(a, block_rows=100)
    assert np.abs(_np(cov) - np.cov(a.T)).max() <= 1e-12 * np.abs(
        np.cov(a.T)).max()
    corr = pst.streamed_pearson_corr(a, block_rows=100)
    want = np.asarray(jst.streamed_pearson_corr(a, block_rows=100))
    assert np.abs(_np(corr) - want).max() <= 1e-12
    assert np.abs(_np(corr) - np.corrcoef(a.T)).max() <= 1e-12


def test_row_block_source_and_memmap(cpu_device, rng, tmp_path):
    a = rng.standard_normal((301, 10))
    src = port.RowBlockSource(lambda lo, hi: a[lo:hi], a.shape,
                              dtype=np.float64)
    path = tmp_path / "a.f64"
    a.tofile(path)
    mm = np.memmap(path, dtype=np.float64, mode="r", shape=a.shape)
    want = np.cov(a.T)
    for source in (src, mm):
        got = _np(pst.streamed_cov(source, block_rows=64))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    with pytest.raises(TypeError, match="contiguous"):
        src[::2]
    bad = port.RowBlockSource(lambda lo, hi: np.zeros((1, 10)), a.shape)
    with pytest.raises(ValueError, match="expected"):
        pst.streamed_gram(bad, block_rows=64)


def test_devices_take_one_device(same_sketch, rng):
    a = rng.standard_normal((200, 8))
    want = _np(pst.streamed_gram(a, block_rows=64)[0])
    for devices in ("cpu", torch.device("cpu"), [torch.device("cpu")]):
        got = pst.streamed_gram(a, block_rows=64, devices=devices)[0]
        assert got.device.type == "cpu"
        assert np.abs(_np(got) - want).max() == 0.0
    # two slots on one device against JAX's two (virtual) devices
    two, jdevs = [torch.device("cpu"), torch.device("cpu")], jax.devices()[:2]
    for p_fn, j_fn in ((lambda *x, **k: pst.streamed_gram(*x, **k)[0],
                        lambda *x, **k: jst.streamed_gram(*x, **k)[0]),
                       (pst.streamed_cov, jst.streamed_cov),
                       (pst.streamed_pearson_corr, jst.streamed_pearson_corr)):
        got = _np(p_fn(a, block_rows=64, devices=two))
        want2 = np.asarray(j_fn(a, block_rows=64, devices=jdevs))
        assert np.abs(got - want2).max() <= 1e-12 * np.abs(want2).max()
    s2 = pst.streamed_random_svd(a, 2, 1, 2, block_rows=64, devices=two)[1]
    s_j = jst.streamed_random_svd(a, 2, 1, 2, block_rows=64, devices=jdevs)[1]
    np.testing.assert_allclose(_np(s2), np.asarray(s_j), rtol=1e-10)
    p2 = pst.streamed_pca(a, 2, block_rows=64, devices=two)[0]
    p_j = jst.streamed_pca(a, 2, block_rows=64, devices=jdevs)[0]
    np.testing.assert_allclose(_np(p2), np.asarray(p_j), rtol=1e-10)
    with pytest.raises(ValueError, match="empty"):
        pst.streamed_gram(a, devices=[])
    with pytest.raises(ValueError, match="requires method='gram'"):
        pst.streamed_random_svd(a, 2, 1, 2, method="power", devices="cpu")


def test_streamed_errors_as_jax(cpu_device, rng):
    a = rng.standard_normal((10, 20))
    with pytest.raises(ValueError, match="n >= m"):
        pst.streamed_random_svd(a, 2, 2, 2)
    with pytest.raises(ValueError, match="tall"):
        pst.streamed_single_pass_svd(a, 2, 2)
    b = rng.standard_normal((20, 5))
    with pytest.raises(ValueError, match="center"):
        pst.streamed_random_svd(b, 2, 2, 2, method="power", center=True)
    with pytest.raises(ValueError, match="method"):
        pst.streamed_random_svd(b, 2, 2, 2, method="banana")
    t = rng.standard_normal((8, 3, 3))
    with pytest.raises(ValueError, match="ranks"):
        pst.streamed_hosvd(t, (2, 2))
    with pytest.raises(ValueError, match="must be in"):
        pst.streamed_hosvd(t, (2, 5, 2))
    with pytest.raises(ValueError, match="exceeds"):
        pst.streamed_hosvd(rng.standard_normal((40, 2, 2)), (5, 2, 2))
    with pytest.raises(ValueError, match="2-D"):
        pst.streamed_pod(rng.standard_normal((4, 5, 6)), np.zeros((4, 1)), 2)
    with pytest.raises(ValueError, match="match"):
        pst.streamed_pod(rng.standard_normal((4, 50)), np.zeros((3, 1)), 2)
    with pytest.raises(ValueError, match="n_u"):
        pst.streamed_dmdc(rng.standard_normal((30, 10)), np.zeros((1, 9)), 2)


def _tucker(core, factors):
    out = np.asarray(core)
    for k, f in enumerate(factors):
        out = np.moveaxis(np.tensordot(np.asarray(f), out, axes=(1, k)), 0, k)
    return out


def test_streamed_hosvd_matches_jax(cpu_device, rng):
    g = rng.standard_normal((3, 2, 2))
    us = [np.linalg.qr(rng.standard_normal((n, r)))[0]
          for n, r in ((123, 3), (6, 2), (5, 2))]
    t = np.einsum("abc,ia,jb,kc->ijk", g, *us)
    t = t + 1e-10 * rng.standard_normal(t.shape)
    core0, fac0 = jst.streamed_hosvd(t, (3, 2, 2), block_slabs=32)
    core1, fac1 = pst.streamed_hosvd(t, (3, 2, 2), block_slabs=32)
    for f, f0 in zip(fac1, fac0):
        f, f0 = _np(f), np.asarray(f0)
        assert np.abs(f.T @ f - np.eye(f.shape[1])).max() <= 1e-10
        assert np.abs(f @ f.T - f0 @ f0.T).max() <= 1e-9
    rec1 = _tucker(_np(core1), [_np(f) for f in fac1])
    assert np.abs(rec1 - _tucker(core0, fac0)).max() <= 1e-10
    assert np.abs(rec1 - t).max() <= 1e-8
    core2, fac2 = pst.streamed_hosvd(t, (3, 2, 2), block_slabs=500,
                                     compute_mode0_rows=False)
    assert fac2[0] is None
    assert np.abs(np.abs(_np(core2)) - np.abs(_np(core1))).max() <= 1e-10


def _pulse_family(n_x=1500, n_s=20):
    xg = np.linspace(0, 10, n_x)
    tg = np.linspace(1, 9, n_s)[:, None]
    return (0.5 * tg) * np.exp(-((xg[None, :] - tg) ** 2) / 4.0), tg


def test_streamed_pod_matches_jax_and_checkpoints(cpu_device, tmp_path):
    p, tg = _pulse_family()
    want = jst.streamed_pod(p, tg, 4, block_cols=400)
    got = pst.streamed_pod(p, tg, 4, block_cols=400)
    m, m0 = _np(got.modes), np.asarray(want.modes)
    assert m.shape == (1500, 4)
    assert np.abs(m.T @ m - np.eye(4)).max() <= 1e-10
    assert np.abs(m @ m.T - m0 @ m0.T).max() <= 1e-10
    tq = np.array([[5.2], [2.5], [7.7]])
    pred = _np(got.predict(tq))
    ref = np.asarray(want.predict(jnp.asarray(tq)))
    assert np.abs(pred - ref).max() <= 1e-10 * np.abs(ref).max()
    path = str(tmp_path / "pod.npz")
    pck.save_model(path, got)
    again = pck.load_model(path, device="cpu")
    assert isinstance(again, port.PodI)
    assert np.abs(_np(again.predict(tq)) - pred).max() == 0.0


def _forced_field(n_x=200, n_t=30):
    xg = np.linspace(0.0, 10.0, n_x)
    tg = np.linspace(0.0, 10.0, n_t)
    u = np.exp(0.2 * tg)[None, :]
    return np.sin(xg[:, None] + 0.2 * tg[None, :]) * u, u


def test_streamed_dmdc_matches_jax_and_checkpoints(cpu_device, tmp_path):
    x, u = _forced_field()
    want = jst.streamed_dmdc(x, u, 6, block_rows=64)
    got = pst.streamed_dmdc(x, u, 6, block_rows=64)
    assert isinstance(got, port.DMDc)
    lam0 = np.sort_complex(np.asarray(want.lambdas))
    assert np.abs(np.sort_complex(got.lambdas) - lam0).max() <= 1e-9
    x0, useq = x[:, :1], u[:, :20]
    ref = np.asarray(want.predict_multiple(jnp.asarray(x0),
                                           jnp.asarray(useq), method="modes"))
    scale = np.abs(ref).max()
    for method in ("modes", "reduced", "dense"):
        out = _np(got.predict_multiple(x0, useq, method=method))
        assert np.abs(out - ref).max() <= 1e-8 * scale, method
    path = str(tmp_path / "dmdc.npz")
    pck.save_model(path, got)
    again = pck.load_model(path, device="cpu")
    out = _np(again.predict_multiple(x0, useq, method="modes"))
    assert np.abs(out - _np(got.predict_multiple(x0, useq, method="modes"))
                  ).max() == 0.0


def test_streamed_models_cross_from_jax(cpu_device):
    # a JAX streamed fit's attributes carry into the port's classes and
    # predict what the JAX model predicts
    from corrla_rs_tpu_torch.utils.convert import from_jax_state

    p, tg = _pulse_family(n_x=600)
    jpod = jst.streamed_pod(p, tg, 4, block_cols=250)
    pod = from_jax_state("PodI", vars(jpod), device="cpu")
    tq = np.array([[3.3], [6.1]])
    ref = np.asarray(jpod.predict(jnp.asarray(tq)))
    assert np.abs(_np(pod.predict(tq)) - ref).max() <= 1e-12 * np.abs(
        ref).max()
    x, u = _forced_field()
    jd = jst.streamed_dmdc(x, u, 6, block_rows=64)
    dm = from_jax_state("DMDc", vars(jd), device="cpu")
    ref = np.asarray(jd.predict_multiple(jnp.asarray(x[:, :1]),
                                         jnp.asarray(u[:, :8]),
                                         method="modes"))
    out = _np(dm.predict_multiple(x[:, :1], u[:, :8], method="modes"))
    assert np.abs(out - ref).max() <= 1e-10 * np.abs(ref).max()


def test_streamed_dmdc_generated_source(cpu_device):
    x, u = _forced_field()
    src = port.RowBlockSource(lambda lo, hi: x[lo:hi], x.shape,
                              dtype=np.float64)
    got = pst.streamed_dmdc(src, u, 6, block_rows=48)
    ref = pst.streamed_dmdc(x, u, 6, block_rows=48)
    assert np.abs(np.sort_complex(got.lambdas)
                  - np.sort_complex(ref.lambdas)).max() == 0.0


def test_each_pass_logs_its_bytes_and_split(cpu_device, rng, caplog):
    a = rng.standard_normal((300, 8))
    with caplog.at_level(logging.INFO, logger="corrla_rs_tpu_torch"):
        pst.streamed_random_svd(a, 2, 1, 2, block_rows=64)
    passes = [r.stream_pass for r in caplog.records
              if hasattr(r, "stream_pass")]
    assert [p["pass"] for p in passes] == ["gram", "Y", "B"]
    for p in passes:
        assert p["bytes"] == a.nbytes and p["blocks"] == 5
        assert p["device"] == "cpu" and p["copy_ms"] is None
        assert p["gb_s"] > 0 and p["fill_s"] >= 0
