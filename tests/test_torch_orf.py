"""Sampled ORF weights (``bin_orf``, ``legendre_orf``): the port against
the JAX package on the CPU, on the same numpy inputs and the JAX-drawn
noise.

The model is ``bench.py``'s HD model cut to the 3 synthetic pulsars of
``small_psrs`` and 4 bins, with the ORF's correlation weights sampled:
``G(theta) = I + sum_j theta_j B_j``.  Tolerance classes (``rel`` is
``max |a - b| / max |b|``, as in ``test_torch_hd.py``):

- the basis, the model arrays, the parameter names, the refusals and
  the non-PD start's message: equal;
- ``orf_G`` and ``orf_ginv_k`` at positive-definite weights, per chain:
  float64 1e-12 relative (both from a blocked Cholesky inverse, in each
  framework's order);
- ``lnlike_orf_fn``: 1e-12 relative (the JAX function solves with the
  library's triangular solve, the port multiplies by the explicit
  inverse factor);
- the ORF weights' MH sub-chain on the JAX-drawn noise: states and
  record to 1e-10 (the accept decisions equal);
- the joint b-draw with a G per chain: float64 rel 1e-10 and two-float
  rel 1e-9, Fourier columns 1e-4 (``test_torch_hd.py``'s classes); the
  rho draw: the same grid point;
- the sampled posterior (``legendre_orf``, ``leg_lmax=1``): every weight
  and common log10_rho within z < 4.5 of the JAX chain's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_cases import close, small_psrs, t32, t64
from test_torch_hd import hd_state, jax_draws, rel, rel_gp

torch.set_num_threads(2)

NB = 4
C = 3
#: bench.py's HD model at 4 bins, the ORF left to each case
HD = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
          common_components=NB, red_var=True, red_psd="spectrum",
          red_components=NB)
#: the cases: ORF, options
CASES = {"bin_orf": dict(orf="bin_orf"),
         "legendre_orf": dict(orf="legendre_orf", leg_lmax=3)}


def jax_pta(name, **extra):
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    jp = [Pulsar(**dataclasses.asdict(p)) for p in small_psrs()]
    return model_general(jp, **{**HD, **CASES[name], **extra})


@functools.lru_cache(maxsize=None)
def models(name):
    """``(jax_cm, port_cm)`` of a case, each from its own package."""
    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    return (compile_pta(jax_pta(name)),
            model_general(small_psrs(), device="cpu", **HD, **CASES[name]))


def orf_state(cm, seed, width=0.3):
    """:func:`hd_state` with each chain's weights uniform in
    ``[-width, width]``, where G stays positive definite."""
    x = hd_state(cm, seed)
    rng = np.random.default_rng(seed + 70)
    ix = cm.orf_par_ix.numpy()
    x[:, ix] = rng.uniform(-width, width, (C, len(ix)))
    G = np.eye(cm.P) + np.einsum("cj,jpq->cpq", x[:, ix], cm.orf_B.numpy())
    assert np.linalg.eigvalsh(G).min() > 0.1
    return x


def _jit(fn, *args):
    import jax
    import jax.numpy as jnp

    out = jax.jit(fn)(*map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


# ---------------------------------------------------------------------------
# the basis and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,lmax", [("bin_orf", 5), ("legendre_orf", 3),
                                       ("legendre_orf", 11),
                                       ("zero_diag_bin_orf", 5)])
def test_basis_matches_jax(name, lmax):
    """``orf_param_basis`` equals the JAX package's on the array's sky
    positions and on 9 seeded ones (7 separation bins, Legendre orders
    0..lmax), labels included; ``BIN_ORF_EDGES`` is the JAX tuple."""
    from pulsar_timing_gibbsspec_torch.models import orf as torf
    from pulsar_timing_gibbsspec_tpu.models import orf as jorf

    assert torf.BIN_ORF_EDGES == jorf.BIN_ORF_EDGES
    v = np.random.default_rng(3).standard_normal((9, 3))
    for pos in ([p.pos for p in small_psrs()],
                list(v / np.linalg.norm(v, axis=1, keepdims=True))):
        Bt, lt = torf.orf_param_basis(name, pos, leg_lmax=lmax)
        Bj, lj = jorf.orf_param_basis(name, pos, leg_lmax=lmax)
        assert lt == lj and np.array_equal(Bt, Bj)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_compile_pta(name):
    """The port's arrays equal ``compile_pta``'s field by field (``orf_B``
    zero-padded on a pad pulsar, ``orf_par_ix``, no ``orf_Ginv``); the
    weights are ``Uniform(-1, 1)`` parameters named as the JAX model
    names them, ``idx.orf`` is the JAX ``BlockIndex.orf``, and an initial
    sample starts them at 0 as the JAX model's does."""
    from test_torch_cases import jax_fields, same_field

    from pulsar_timing_gibbsspec_torch import PTABlockGibbs
    from pulsar_timing_gibbsspec_torch.models.build import model_arrays
    from pulsar_timing_gibbsspec_tpu.sampler.blocks import BlockIndex
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    pta = jax_pta(name)
    opts = {k: v for k, v in {**HD, **CASES[name]}.items()
            if k != "white_vary"}
    for pad in (None, 4):
        want = jax_fields(compile_pta(pta, pad_pulsars=pad))
        got = model_arrays(small_psrs(), pad_pulsars=pad, **opts)
        assert list(got["param_names"]) == list(pta.param_names)
        assert got["orf_Ginv"] is None and got["orf_B"].shape[1] == (pad or 3)
        for key, v in want.items():
            if key == "components":
                for c, d in zip(v, got[key]):
                    for k in c:
                        same_field(c[k], d[k], f"components.{k}")
            elif key not in ("dtype", "cdtype"):
                same_field(v, got[key], key)
    _, cmt = models(name)
    jidx = BlockIndex.build(pta.param_names)
    assert np.array_equal(cmt.idx.orf, jidx.orf)
    assert np.array_equal(np.sort(cmt.orf_par_ix.numpy()), jidx.orf)
    for q in cmt.params():
        if "_orfw_" in q.name:
            assert (q.prior, q.a, q.b, q.size) == ("Uniform", -1.0, 1.0, None)
    x0 = PTABlockGibbs(cmt, nchains=C, device="cpu").initial_sample(
        torch.Generator().manual_seed(0))
    assert bool((x0[:, cmt.idx.orf] == 0).all())
    assert np.array_equal(pta.initial_sample(np.random.default_rng(0))[
        jidx.orf], np.zeros(len(jidx.orf)))
    others = np.setdiff1d(np.arange(cmt.nx), cmt.idx.orf)
    assert bool((x0[:, others] != 0).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_orf_G_and_ginv_match_jax(name):
    """``orf_G`` (C, P, P) and ``orf_ginv_k`` (C, K, P, P) at C chains'
    positive-definite weights equal the JAX functions vmapped over the
    chains (1e-12); at zero weights G^-1 is the identity stack."""
    import jax

    cmj, cmt = models(name)
    x = orf_state(cmt, seed=1)
    Gj, Gij = _jit(jax.vmap(lambda x: (cmj.orf_G(x), cmj.orf_ginv_k(x))), x)
    Gt, Git = cmt.orf_G(t64(x)), cmt.orf_ginv_k(t64(x))
    assert Gt.shape == (C, cmt.P, cmt.P)
    assert Git.shape == (C, cmt.K, cmt.P, cmt.P)
    close(Gt, Gj, rtol=0, atol=1e-12 * np.abs(Gj).max())
    close(Git, Gij, rtol=0, atol=1e-12 * np.abs(Gij).max())
    eye = torch.eye(cmt.P, dtype=torch.float64).expand(cmt.K, -1, -1)
    close(cmt.orf_ginv_k(torch.zeros(cmt.nx, dtype=torch.float64)), eye,
          rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lnlike_orf_matches_jax(name):
    """``lnlike_orf_fn`` per chain at the chains' own b and weights equals
    the JAX function's (1e-12 relative); a non-positive-definite G is not
    finite there."""
    import jax

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models(name)
    x = orf_state(cmt, seed=2)
    b, _ = jax_draws(cmj, x, 21, exact=True)
    llj = _jit(jax.vmap(lambda x, b: jb.lnlike_orf_fn(cmj, b)(x)), x, b)
    llt = blocks.lnlike_orf_fn(cmt, t64(b))(t64(x))
    close(llt, llj, rtol=1e-12)
    xb = x.copy()
    xb[:, cmt.orf_par_ix.numpy()] = -0.95
    assert not torch.isfinite(
        blocks.lnlike_orf_fn(cmt, t64(b))(t64(xb))).any()


def test_orf_mh_scan_matches_jax_noise():
    """The ORF weights' MH sub-chain (20 steps per chain) on the JAX-drawn
    noise equals JAX's ``mh_scan`` on ``lnlike_orf_fn`` (1e-10), with the
    accepted steps counted; from weights near the edge of the
    positive-definite region, proposals inside the prior whose G is not
    positive definite are proposed and rejected."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models("bin_orf")
    ix = cmt.orf_par_ix.numpy()
    x = orf_state(cmt, seed=3)
    # the three pairs' bins at -0.45: G's least eigenvalue is 0.1
    Bt = cmt.orf_B.numpy()
    live = [j for j in range(len(ix)) if Bt[j].any()]
    x[:, ix[live]] = -0.45
    b, _ = jax_draws(cmj, x, 22, exact=True)
    ind = np.asarray(cmt.idx.orf)
    cdt = jnp.float64
    nsteps = 20

    def run(x, b, key):
        out = jb.mh_scan(cmj, x, key, jb.lnlike_orf_fn(cmj, b), ind, nsteps)
        noise = []
        for k in jr.split(key, nsteps):
            k1, k2, k3, k4 = jr.split(k, 4)
            noise.append((
                jr.choice(k1, jnp.asarray(jb._SCALES, cdt),
                          p=jnp.asarray(jb._SCALE_P, cdt)),
                jr.randint(k2, (), 0, len(ind)),
                jr.normal(k3, dtype=cdt),
                jnp.log(jr.uniform(k4, dtype=cdt))))
        return out, [jnp.stack(v) for v in zip(*noise)]

    keys = jr.split(jr.PRNGKey(23), C)
    (xj, recj), (scale, jpos, eps, logu) = _jit(jax.vmap(run), x, b, keys)
    acc = torch.zeros(C, dtype=torch.float64)
    noise = [t64(scale.T), torch.tensor(jpos.T, dtype=torch.int64),
             t64(eps.T), t64(logu.T)]
    xt, rect = blocks.mh_scan_core(cmt, t64(x), blocks.lnlike_orf_fn(
        cmt, t64(b)), ind, *noise, accepts=acc)
    close(xt, xj, rtol=0, atol=1e-10)
    close(rect, recj.transpose(1, 0, 2), rtol=0, atol=1e-10)
    # replay the proposals: the accepted ones moved the chain, the
    # non-PD ones inside the prior did not
    rec = np.concatenate([x[None, :, ind], rect.numpy()])
    prop = cmt.prop_scale.numpy().astype(np.float64)
    moved = rejected_nonpd = 0
    for s in range(nsteps):
        for c in range(C):
            j = ind[jpos[c, s]]
            q = rec[s, c].copy()
            q[jpos[c, s]] += eps[c, s] * prop[j] * scale[c, s]
            G = np.eye(cmt.P) + np.einsum("j,jpq->pq", q, Bt)
            stayed = np.array_equal(rec[s + 1, c], rec[s, c])
            moved += not stayed
            if abs(q[jpos[c, s]]) < 1 and np.linalg.eigvalsh(G).min() <= 0:
                assert stayed
                rejected_nonpd += 1
    assert rejected_nonpd > 0
    assert acc.sum().item() == moved > 0


# ---------------------------------------------------------------------------
# the joint b-draw and the rho draw with a G per chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
def test_structured_draw_per_chain_matches_jax(exact):
    """The structured joint draw with each chain's G(theta) equals JAX's
    vmapped ``draw_b_joint_structured`` at the same normals: float64 rel
    1e-10, two-float rel 1e-9, Fourier columns 1e-4; the dense draw
    agrees (1e-8)."""
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    cmj, cmt = models("legendre_orf")
    x = orf_state(cmt, seed=4)
    kw = dict(exact=True) if exact else dict(exact=False, mixed=True)
    bj, z = jax_draws(cmj, x, 24, **kw)
    bt, ok = blocks.draw_b_joint_structured_core(cmt, t64(x), t64(z), **kw)
    assert bool(ok.all())
    assert rel(bt, bj) < (1e-10 if exact else 1e-9)
    assert rel_gp(cmt, bt, bj) < 1e-4
    if exact:
        assert rel(blocks.draw_b_joint(cmt, t64(x), t64(z)), bt) < 1e-8


def test_rho_draw_per_chain_matches_jax():
    """The correlated-ORF rho draw with each chain's G(theta) equals JAX's
    vmapped ``rho_update`` on the JAX-drawn Gumbels (the same grid
    point)."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.config import settings
    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models("bin_orf")
    x = orf_state(cmt, seed=5)
    b, _ = jax_draws(cmj, x, 25, exact=True)

    def one(x, b, k):
        return (jb.rho_update(cmj, x, b, k),
                jr.gumbel(k, (cmj.K, settings.rho_grid_size),
                          dtype=cmj.dtype))

    xj, gum = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(b),
                                     jr.split(jr.PRNGKey(26), C))
    xt = blocks.rho_update_core(cmt, t64(x), t64(b), t32(np.asarray(gum)))
    rix = cmt.rho_ix_x.numpy()
    close(xt[:, rix], np.asarray(xj)[:, rix], rtol=1e-5)
    # the weights matter: at G = I the draw differs
    x0 = x.copy()
    x0[:, cmt.orf_par_ix.numpy()] = 0.0
    xi = blocks.rho_update_core(cmt, t64(x0), t64(b), t32(np.asarray(gum)))
    assert not torch.equal(xi[:, rix], xt[:, rix])


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def test_non_pd_start_raises_jax_error(tmp_path):
    """A start whose weights give a non-positive-definite G raises the JAX
    driver's ``ValueError``, word for word; the sweep runs the ORF MH
    after rho and before the joint b-draw."""
    import pulsar_timing_gibbsspec_torch as ptt
    import pulsar_timing_gibbsspec_tpu.sampler.gibbs as jgibbs

    pta = jax_pta("bin_orf")
    _, cmt = models("bin_orf")
    x0 = pta.initial_sample(np.random.default_rng(0))
    x0[cmt.idx.orf] = -0.99
    jg = jgibbs.PTABlockGibbs(pta, backend="jax", seed=1, progress=False)
    with pytest.raises(ValueError) as ref:
        jg.sample(x0, outdir=str(tmp_path / "jax"), niter=10)
    g = ptt.PTABlockGibbs(cmt, nchains=2, device="cpu", seed=1,
                          progress=False)
    with pytest.raises(ValueError) as port:
        g.sample(x0, outdir=tmp_path / "torch", niter=10)
    assert str(port.value) == str(ref.value)
    drv = g.driver
    assert drv._hyper_blocks() + [drv._b_block(False)] == [
        "red", "rho", "orf_mh", "b_joint"]


def _pooled(chain, cols, burn):
    """Per column, the mean over chains of each chain's mean after
    ``burn`` and its squared standard error: the larger of the ACT-based
    one (each chain's variance over its effective sample size) and the
    spread of the chains' means, which also sees a chain that stays in a
    corner for much of the run."""
    from pulsar_timing_gibbsspec_torch.ops.acf import integrated_act_columns

    r = chain[burn:][:, :, cols]                              # (n, C, k)
    n, nc, _ = r.shape
    m = r.mean(0)
    act = np.stack([integrated_act_columns(r[:, c]) for c in range(nc)])
    se2 = np.maximum((r.var(0) * np.maximum(act, 1.0) / n).sum(0) / nc ** 2,
                     m.var(0, ddof=1) / nc)
    return m.mean(0), se2


def test_legendre_posterior_matches_jax(tmp_path):
    """``legendre_orf`` with ``leg_lmax=1`` (3 pulsars, 4 bins, fixed white
    noise, no red noise) sampled by both packages' ``PTABlockGibbs``: 8
    chains each from the same seeded prior draws (weights at 0), 5 warmup
    and 494 steady sweeps; every weight and common log10_rho agrees, z <
    4.5 with the standard errors of :func:`_pooled`."""
    import pulsar_timing_gibbsspec_torch as ptt
    import pulsar_timing_gibbsspec_tpu.sampler.gibbs as jgibbs

    nc, warm, niter, burn = 8, 5, 500, 100
    opts = dict(tm_svd=True, red_var=False, white_vary=False,
                common_psd="spectrum", common_components=NB,
                orf="legendre_orf", leg_lmax=1)
    pta = jax_pta("legendre_orf", **opts)
    rng = np.random.default_rng(4)
    x0 = np.stack([pta.initial_sample(rng) for _ in range(nc)])
    jg = jgibbs.PTABlockGibbs(pta, backend="jax", progress=False, nchains=nc,
                              seed=7, warmup_sweeps=warm,
                              chunk_size=niter - warm - 1)
    jchain = jg.sample(x0, outdir=str(tmp_path / "jax"), niter=niter)
    cm = ptt.model_general(small_psrs(), device="cpu", **opts)
    tg = ptt.PTABlockGibbs(cm, nchains=nc, device="cpu", seed=8,
                           warmup_sweeps=warm, progress=False)
    tchain = tg.sample(x0, outdir=tmp_path / "torch", niter=niter)
    assert np.isfinite(tchain).all()
    cols = list(cm.idx.orf) + list(cm.idx.rho)
    assert len(cm.idx.orf) == 2
    (mj, sj), (mt, st) = _pooled(jchain, cols, burn), _pooled(tchain, cols,
                                                              burn)
    z = np.abs(mj - mt) / np.sqrt(sj + st)
    assert np.all(z < 4.5), dict(zip([cm.param_names[c] for c in cols],
                                     zip(mj, mt, z)))
    acc = tg.driver.orf_mh_accepts / (tg.driver.orf_mh_sweeps
                                      * tg.driver.red_steps)
    assert bool(((acc > 0.05) & (acc < 0.95)).all())
