"""Fused D = 2 energy objective vs the independent fixed-point path.

The reference energy is computed through mps.transfer.right_fixed_point
(its own custom implicit adjoint — an INDEPENDENT derivation), so value
and gradient agreement here cross-validates the fused objective's
hand-derived deflated-series eigenvector adjoint end to end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmps_tpu.kernels.energy_fused import energy_objective_fused
from qmps_tpu.mps import transfer as tr
from qmps_tpu.mps.imps import iMPS


def _e_ref_one(A, h):
    AA = jnp.einsum("sik,tkj->stij", A, A).reshape(4, 2, 2)
    _, r = tr.right_fixed_point(AA, AA)
    r = (r + r.conj().T) / 2
    r = r / jnp.trace(r)
    return jnp.einsum("ts,sij,jk,tik->", h.astype(A.dtype), AA, r, AA.conj()).real


def test_host_energy_matches_jax_path():
    """ham.classical_baselines.host_energy_d2 (the bench/probe validation
    column) == the differentiable fixed-point path."""
    from qmps_tpu.ham.classical_baselines import host_energy_d2

    As, hs = _batch(3)
    for b in range(3):
        e_np = host_energy_d2(np.asarray(As[b]), np.asarray(hs[b]))
        e_jx = float(_e_ref_one(As[b], hs[b]))
        np.testing.assert_allclose(e_np, e_jx, atol=1e-12)


import functools


@functools.lru_cache(maxsize=4)
def _batch(B=5):
    ks = jax.random.split(jax.random.PRNGKey(0), B)
    As = jnp.stack([iMPS.random(k, 2, 2).left_canonicalise()[0] for k in ks])
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    I2 = np.eye(2)
    hs = jnp.stack(
        [
            jnp.asarray(-np.kron(Z, Z) + g / 2 * (np.kron(X, I2) + np.kron(I2, X)))
            for g in np.linspace(0.3, 1.7, B)
        ]
    )
    return As, hs


def test_forward_matches_fixed_point_path():
    As, hs = _batch()
    e_f = energy_objective_fused(As, hs, 48, False, "xla")
    e_r = jax.vmap(_e_ref_one)(As, hs)
    np.testing.assert_allclose(np.asarray(e_f), np.asarray(e_r), atol=1e-12)


def test_gradient_matches_fixed_point_path():
    """The money test: the deflated product-form eigenvector adjoint vs
    jax.grad through right_fixed_point's independent implicit adjoint."""
    As, hs = _batch()
    gf = jax.grad(lambda a: jnp.sum(energy_objective_fused(a, hs, 48, False, "xla")))(As)
    gr = jax.grad(lambda a: jnp.sum(jax.vmap(_e_ref_one)(a, hs)))(As)
    np.testing.assert_allclose(np.asarray(gf), np.asarray(gr), atol=1e-10)
    gfh = jax.grad(lambda h: jnp.sum(energy_objective_fused(As, h, 48, False, "xla")))(hs)
    grh = jax.grad(lambda h: jnp.sum(jax.vmap(_e_ref_one)(As, h)))(hs)
    np.testing.assert_allclose(np.asarray(gfh), np.asarray(grh), atol=1e-10)


def test_shared_h_broadcast_and_sum():
    """Shared (4, 4) h broadcasts across the batch; its cotangent is the
    batch sum."""
    As, hs = _batch(3)
    h0 = hs[0]
    e = energy_objective_fused(As, h0, 48, False, "xla")
    e_b = energy_objective_fused(As, jnp.broadcast_to(h0, (3, 4, 4)), 48, False, "xla")
    np.testing.assert_allclose(np.asarray(e), np.asarray(e_b), atol=1e-13)
    g = jax.grad(lambda h: jnp.sum(energy_objective_fused(As, h, 48, False, "xla")))(h0)
    gb = jax.grad(
        lambda h: jnp.sum(energy_objective_fused(As, jnp.broadcast_to(h, (3, 4, 4)), 48, False, "xla"))
    )(h0)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gb), atol=1e-12)


@pytest.mark.slow
def test_near_critical_gradient():
    """g ~ 1 states have subdominant transfer eigenvalues near 1 (long
    correlation length) — the log-time series must still converge where a
    plain Neumann sum would need thousands of terms."""
    from qmps_tpu.algorithms.ground_state import find_ground_state
    from qmps_tpu.circuits.ansatze import shallow_full_state
    from qmps_tpu.embed.unitaries import unitary_to_tensor
    from qmps_tpu.ham import Hamiltonian

    gs = find_ground_state(
        Hamiltonian({"ZZ": -1.0, "X": 1.0}), D=2, ansatz="full15",
        method="lbfgs", steps=200, key=jax.random.PRNGKey(3),
    )
    As = jnp.stack([unitary_to_tensor(shallow_full_state(gs.params))])
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    I2 = np.eye(2)
    hs = jnp.asarray(-np.kron(Z, Z) + 0.5 * (np.kron(X, I2) + np.kron(I2, X)))[None]
    gf = jax.grad(lambda a: jnp.sum(energy_objective_fused(a, hs, 48, False, "xla")))(As)
    gr = jax.grad(lambda a: jnp.sum(jax.vmap(_e_ref_one)(a, hs)))(As)
    np.testing.assert_allclose(np.asarray(gf), np.asarray(gr), atol=1e-8)


def test_pallas_forward_matches_xla_engine():
    """The fused Triton kernel (interpret mode, f32 planes) against the x64
    XLA specification of the same math."""
    As, hs = _batch(3)
    e_k = energy_objective_fused(
        As.astype(jnp.complex64), hs.astype(jnp.float32), 32, True, "pallas"
    )
    e_x = energy_objective_fused(As, hs, 48, False, "xla")
    np.testing.assert_allclose(np.asarray(e_k), np.asarray(e_x), atol=2e-5)


@pytest.mark.slow
def test_pallas_gradient_matches_xla_engine():
    """Kernel adjoint (one launch: rebuild + deflated series + transposed
    builds) against the validated XLA adjoint, batched and shared h."""
    As, hs = _batch(2)
    As32, hs32 = As.astype(jnp.complex64), hs.astype(jnp.float32)

    gk = jax.grad(
        lambda a: jnp.sum(energy_objective_fused(a, hs32, 32, True, "pallas"))
    )(As32)
    gx = jax.grad(
        lambda a: jnp.sum(energy_objective_fused(a, hs, 48, False, "xla"))
    )(As)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gx), atol=3e-4)

    ghk = jax.grad(
        lambda h: jnp.sum(energy_objective_fused(As32, h, 32, True, "pallas"))
    )(hs32)
    ghx = jax.grad(
        lambda h: jnp.sum(energy_objective_fused(As, h, 48, False, "xla"))
    )(hs)
    np.testing.assert_allclose(np.asarray(ghk), np.asarray(ghx), atol=3e-4)


def _sweep_batch(B, seed=0):
    """B left-canonical tensors in the fused sweep's layout, with TFIM h
    across the phase diagram (float32, the accelerator dtype)."""
    from qmps_tpu.parallel.sweep import tfim_matrix

    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.normal(size=(B, 4, 2)) + 1j * rng.normal(size=(B, 4, 2)))
    As = jnp.asarray(V.reshape(-1, 2, 2, 2).transpose(0, 2, 1, 3), jnp.complex64)
    hs = jax.vmap(tfim_matrix)(jnp.linspace(0.1, 2.0, B)).real.astype(jnp.float32)
    return As, hs


def test_pallas_gradient_interpret():
    """Fast-suite gradient parity of the Triton adjoint kernel (interpret
    mode) with the XLA engine, both in float32."""
    As, hs = _sweep_batch(5)
    f = lambda eng: jax.grad(
        lambda a: jnp.sum(energy_objective_fused(a, hs, 48, eng == "pallas", eng))
    )(As)
    gk, gx = f("pallas"), f("xla")
    assert gk.dtype == As.dtype
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gx), atol=2e-5)


def test_pallas_batch_not_multiple_of_block():
    """A batch of BLOCK + 5 elements: two programs, the second mostly
    padding; the padded lanes are dropped and the rest agree."""
    from qmps_tpu.kernels.energy_fused import BLOCK

    B = BLOCK + 5
    As, hs = _sweep_batch(B, seed=1)
    e_k = energy_objective_fused(As, hs, 48, True, "pallas")
    e_x = energy_objective_fused(As, hs, 48, False, "xla")
    assert e_k.shape == (B,)
    np.testing.assert_allclose(np.asarray(e_k), np.asarray(e_x), atol=2e-5)


def test_pallas_shared_h_matches_batched():
    """A shared (4, 4) h (one 16-entry operand) gives the same energies as
    the same h broadcast to (B, 4, 4) planes, and its cotangent is the
    batch sum."""
    As, hs = _sweep_batch(4, seed=2)
    h0 = hs[1]
    hb = jnp.broadcast_to(h0, (4, 4, 4))
    e_s = energy_objective_fused(As, h0, 48, True, "pallas")
    e_b = energy_objective_fused(As, hb, 48, True, "pallas")
    np.testing.assert_allclose(np.asarray(e_s), np.asarray(e_b), atol=1e-6)
    g_s = jax.grad(lambda h: jnp.sum(energy_objective_fused(As, h, 48, True, "pallas")))(h0)
    g_x = jax.grad(lambda h: jnp.sum(energy_objective_fused(As, h, 48, False, "xla")))(h0)
    assert g_s.shape == (4, 4)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_x), atol=5e-5)


def test_engine_choice_and_validation(monkeypatch):
    """engine=None picks the kernel on a GPU and XLA elsewhere; unknown
    engines and malformed shapes are refused."""
    from qmps_tpu.kernels import energy_fused as ef

    assert ef.default_engine() == "xla"  # the suite runs on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ef.default_engine() == "pallas"
    assert ef.default_engine("xla") == "xla"
    with pytest.raises(ValueError, match="engine"):
        ef.default_engine("mosaic")
    As, hs = _batch(3)
    with pytest.raises(ValueError, match="hs"):
        energy_objective_fused(As, hs[:2], 48, False, "xla")
    with pytest.raises(ValueError, match="As"):
        energy_objective_fused(As[0], hs, 48, False, "xla")


def test_planes_layout_and_padding():
    """The component-major plane layout: (B, ...) complex -> (ncomp, Bp)
    float32 planes, element b in column b, zero padding after B."""
    from qmps_tpu.kernels.energy_fused import _planes

    x = (np.arange(12) + 1j * np.arange(12, 24)).reshape(3, 2, 2)
    re, im = _planes(jnp.asarray(x), 4, 8)
    assert re.shape == im.shape == (4, 8) and re.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(re)[:, :3], x.reshape(3, 4).real.T)
    np.testing.assert_array_equal(np.asarray(im)[:, :3], x.reshape(3, 4).imag.T)
    assert not np.any(np.asarray(re)[:, 3:]) and not np.any(np.asarray(im)[:, 3:])


@pytest.mark.parametrize("h_shape", ["batched", "shared"])
def test_kernel_lowers_for_cuda(h_shape):
    """Both kernels lower through Pallas's Triton route for a CUDA target
    at the sweep's width (4096), on a machine with no GPU: every primitive
    in them has a Triton lowering.  (Compiling the Triton IR itself needs
    the card: test_compiled_kernel_on_gpu.)"""
    from jax import export

    def f(a, h):
        e, vjp = jax.vjp(lambda a: energy_objective_fused(a, h, 48, False, "pallas"), a)
        return e, vjp(jnp.ones_like(e))[0]

    hs = (4096, 4, 4) if h_shape == "batched" else (4, 4)
    exp = export.export(
        jax.jit(f), platforms=("cuda",),
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(jax.ShapeDtypeStruct((4096, 2, 2, 2), jnp.complex64),
      jax.ShapeDtypeStruct(hs, jnp.float32))
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 2  # forward + adjoint
    assert "_energy_fwd_kernel" in text and "_energy_bwd_kernel" in text


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4096, 65536])
def test_compiled_kernel_on_gpu(gpu_only, B):
    """The compiled Triton kernels on the card against the XLA twin
    (repeated at full size by chip_smoke.py phase 2)."""
    As, hs = _sweep_batch(B, seed=3)

    def vg(engine):
        def f(a):
            e, vjp = jax.vjp(lambda x: energy_objective_fused(x, hs, 48, False, engine), a)
            return e, vjp(jnp.ones_like(e))[0]
        return jax.jit(f)(As)

    (ek, gk), (ex, gx) = vg("pallas"), vg("xla")
    assert float(jnp.max(jnp.abs(ek - ex))) < 1e-5
    assert float(jnp.linalg.norm(gk - gx) / jnp.linalg.norm(gx)) < 1e-4
