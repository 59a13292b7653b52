"""The port's model build and compiled-model methods against the JAX
package.

- ``crn_spectrum_arrays`` equals ``compile_pta(model_general(...))``
  field by field: same arrays, dtypes, shapes, parameter order and
  constant pool (exact equality).
- The compiled model's methods agree with the JAX ``CompiledPTA``'s on
  one seeded state: float64 results to 1e-12 relative (the two
  frameworks' ``pow``/``log`` differ in the last bits), float32 results
  to 2e-6 relative (a few float32 ULP), the prior to one float32 ULP of
  its per-parameter constant (both sides evaluate it from float32
  bounds).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.models.build import (build_crn_spectrum,
                                                        crn_spectrum_arrays)
from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays
from test_torch_cases import (close, jax_compiled, jax_fields, models,
                              same_field, small_psrs, state, t64)

torch.set_num_threads(2)


@pytest.mark.parametrize("nbins,red_bins,pad", [
    (4, 4, None), (3, 5, None), (5, 3, 4)])
def test_build_matches_compile_pta(nbins, red_bins, pad):
    psrs = small_psrs()
    ref = jax_fields(jax_compiled(psrs, nbins, red_bins, pad_pulsars=pad))
    got = crn_spectrum_arrays(psrs, nbins, red_bins, pad_pulsars=pad)
    assert set(ref) <= set(got)
    for name, v in ref.items():
        if name == "components":
            assert len(v) == len(got[name])
            for c, d in zip(v, got[name]):
                for k in c:
                    same_field(c[k], d[k], f"components.{k}")
        elif name in ("dtype", "cdtype"):
            assert np.dtype(v) == np.dtype(got[name])
        else:
            same_field(v, got[name], name)


def test_from_arrays_carries_the_jax_model():
    """The JAX model's arrays and the port's own build give the same
    tensors (the weights-carried-across path)."""
    psrs = small_psrs()
    a = from_arrays(jax_fields(jax_compiled(psrs)), device="cpu")
    b = build_crn_spectrum(psrs, 4, 4, device="cpu")
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(va):
            assert torch.equal(va, vb), f.name
    assert a.param_names == b.param_names
    assert np.array_equal(a.idx.white, b.idx.white)
    assert np.array_equal(a.idx.rho, b.idx.rho)


def test_unsupported_models_are_refused():
    fields = jax_fields(jax_compiled(small_psrs()))
    # a correlated ORF whose common process shares its columns with the
    # intrinsic red noise (compile_pta refuses it; correlated ORFs, fixed
    # or with sampled weights, are in the port on columns of their own)
    with pytest.raises(NotImplementedError, match="sharing the common"):
        from_arrays(dict(fields, orf_name="bin_orf",
                         orf_B=np.zeros((7, 3, 3))), device="cpu")
    # a PSD or component kind the JAX package does not compile (kernel
    # ECORR, the t-process and infinitepower are in the port)
    with pytest.raises(NotImplementedError):
        from_arrays(dict(fields, red_kind="tprocess_adapt"), device="cpu")
    with pytest.raises(NotImplementedError):
        from_arrays(dict(fields, components=[dict(
            fields["components"][0], kind="bogus")]), device="cpu")


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    psrs = small_psrs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_crn_spectrum(psrs, 4, 4)
    cm = build_crn_spectrum(psrs, 4, 4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTABlockGibbs(cm)
    assert PTABlockGibbs(cm, device="cpu").cm is cm


@pytest.mark.parametrize("batched", [False, True])
def test_compiled_methods_match_jax(batched):
    import jax
    import jax.numpy as jnp

    cmj, cmt = models()
    C = 3 if batched else None
    x = state(cmt, C=C, seed=3)
    rng = np.random.default_rng(4)
    b = rng.normal(size=(x.shape[:-1] + (cmt.P, cmt.Bmax))) * 1e-7

    ix = np.asarray(cmj.white_par_ix)
    v = x[..., np.minimum(ix, cmt.nx - 1)] + 0.01

    def jax_side(x, b, v):
        return dict(
            xe=cmj.xe(x), ndiag=cmj.ndiag(x), ndiag_fast=cmj.ndiag_fast(x),
            phi=cmj.phi(x), phi32=cmj.phi(x, dtype=jnp.float32),
            lnprior=cmj.lnprior(x), gw_tau=cmj.gw_tau(b),
            red_tau=cmj.red_tau(b), gw_phi=cmj.gw_phi(x),
            gw_phi_at_red=cmj.gw_phi_at_red(x), red_phi=cmj.red_phi(x),
            coord=cmj.coord_logpdf(jnp.asarray(ix), v))

    fn = jax.vmap(jax_side) if batched else jax_side
    ref = {k: np.asarray(a) for k, a in jax.jit(fn)(x, b, v).items()}
    xt, bt = t64(x), t64(b)
    close(cmt.xe(xt), ref["xe"], 0)
    close(cmt.ndiag(xt), ref["ndiag"], 1e-12)
    close(cmt.ndiag_fast(xt), ref["ndiag_fast"], 2e-6)
    close(cmt.phi(xt), ref["phi"], 1e-12)
    close(cmt.phi(xt, dtype=torch.float32), ref["phi32"], 2e-6)
    # the prior constants are float32 arithmetic on both sides (float32
    # bounds): one float32 ULP of log(width) per parameter
    close(cmt.lnprior(xt), ref["lnprior"], 0, atol=cmt.nx * 4 * 2.0 ** -23)
    close(cmt.gw_tau(bt), ref["gw_tau"], 1e-14)
    close(cmt.red_tau(bt), ref["red_tau"], 1e-14)
    close(cmt.gw_phi(xt), ref["gw_phi"], 1e-12)
    close(cmt.gw_phi_at_red(xt), ref["gw_phi_at_red"], 1e-12)
    close(cmt.red_phi(xt), ref["red_phi"], 1e-12)
    close(cmt.coord_logpdf(cmt.white_par_ix, t64(v)), ref["coord"], 1e-12)


def test_lnprior_outside_support_is_minus_inf():
    _, cmt = models()
    x = t64(state(cmt))
    x[cmt.idx.white[0]] = -1.0            # efac below its 0.01 floor
    assert cmt.lnprior(x).item() == -np.inf
