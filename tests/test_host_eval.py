"""Host-side f64 re-evaluation (utils/host_eval.py) vs a dense-eig mirror.

These helpers produce the error-budget columns of bench.py and
chip_smoke.py (docs/DESIGN.md 4d); a biased readout there silently
corrupts every published accuracy number, so pin them against the
brute-force (D^2, D^2) dense transfer eigendecomposition — affordable at
test sizes, unaffordable at bench sizes, which is why the production
path is warm power iteration / ARPACK.
"""
import jax
import jax.numpy as jnp
import numpy as np

from qmps_tpu.mps.imps import iMPS, left_orthogonalise
from qmps_tpu.utils.host_eval import (
    device_to_host_c128,
    host_energy_gauge_free,
    host_f64_sweep_energies,
    tfim_h64_batch,
)

# the helpers transfer device tensors through f32 planes — hand the
# MIRROR the same rounded tensors so the
# comparison isolates the f64 readout, not the transfer rounding


def _dense_energy(A, h):
    """f64 mirror: dominant left/right eigvecs of the dense transfer
    matrix, gauge-free two-site energy."""
    A, h = np.asarray(A, complex), np.asarray(h, complex)
    d, D, _ = A.shape
    T = np.einsum("sij,skl->ikjl", A, A.conj()).reshape(D * D, D * D)
    w, vr = np.linalg.eig(T)
    i = np.argmax(np.abs(w))
    lam = np.abs(w[i])
    wl, vl = np.linalg.eig(T.conj().T)
    j = np.argmax(np.abs(wl))

    def herm(m):
        tr = np.trace(m)
        m = m * (np.conj(tr) / abs(tr))
        return (m + m.conj().T) / 2

    r = herm(vr[:, i].reshape(D, D))
    l = herm(vl[:, j].reshape(D, D))
    A2 = np.einsum("sij,tjk->stik", A, A).reshape(d * d, D, D)
    num = np.einsum("ts,ai,sij,jk,tak->", h, l, A2, r, A2.conj(),
                    optimize=True)
    return (num / (lam ** 2 * np.einsum("ai,ia->", l, r))).real


def _random_left_canonical(key, D, d=2):
    A = iMPS.random(key, d, D)[0]
    AL, _, _ = left_orthogonalise(A)
    return AL


class TestSweepEnergies:
    def test_matches_dense_mirror_warm(self, key):
        """Warm start from the true fixed point: batch of random
        left-canonical tensors, three g-values, 1e-9 agreement with the
        dense two-boundary mirror (the readout converges BOTH fixed
        points — an identity-left shortcut would sit ~5e-9 off here and
        ~5e-6 off on f32 polar-retracted isometries at D=16)."""
        gvals = np.array([0.4, 1.0, 1.6])
        As, rs = [], []
        for k in jax.random.split(key, 3):
            AL = _random_left_canonical(k, D=6)
            # true right fixed point of a left-canonical tensor
            from qmps_tpu.mps import transfer as tr
            _, r = tr.right_fixed_point(AL, AL)
            r = (r + r.conj().T) / 2
            As.append(np.asarray(AL))
            rs.append(np.asarray(r / jnp.linalg.norm(r)))
        As, rs = jnp.asarray(np.stack(As)), jnp.asarray(np.stack(rs))
        e64, lam = host_f64_sweep_energies(As, rs, tfim_h64_batch(gvals))
        h = tfim_h64_batch(gvals)
        A_host = device_to_host_c128(As)
        for b in range(3):
            assert abs(e64[b] - _dense_energy(A_host[b], h[b])) < 1e-9
        # left-canonical tensors have unit dominant eigenvalue, again up
        # to the f32-transfer rounding of A (quadratic in the defect but
        # the defect enters lam linearly through normalization)
        assert np.abs(lam - 1.0).max() < 1e-6

    def test_masked_adaptive_converges_from_cold_start(self, key):
        """A BAD warm start (random hermitian r0) must still converge:
        the masked adaptive loop keeps iterating only unconverged points
        until every residual passes tol, so the readout cannot depend on
        warm-start quality (the bug class this file exists to prevent:
        min_error < 0, energies below the variational bound)."""
        gvals = np.array([0.9, 1.0, 1.1])  # near-critical: worst gaps
        As, r0s = [], []
        for i, k in enumerate(jax.random.split(key, 3)):
            As.append(np.asarray(_random_left_canonical(k, D=5)))
            m = np.asarray(
                jax.random.normal(jax.random.fold_in(k, 7), (5, 5))
            ).astype(complex)
            r0s.append((m + m.T) / 2)
        As, r0s = jnp.asarray(np.stack(As)), jnp.asarray(np.stack(r0s))
        e64, _ = host_f64_sweep_energies(As, r0s, tfim_h64_batch(gvals))
        h = tfim_h64_batch(gvals)
        A_host = device_to_host_c128(As)
        for b in range(3):
            assert abs(e64[b] - _dense_energy(A_host[b], h[b])) < 1e-9

    def test_krylov_fallback_tail(self, key):
        """Force the ARPACK fallback (power budget too small to converge
        from a cold start) and require the same dense-mirror agreement:
        the slow-gap tail path must be as exact as the power path."""
        gvals = np.array([0.8, 1.2])
        As, r0s = [], []
        for k in jax.random.split(key, 2):
            As.append(np.asarray(_random_left_canonical(k, D=5)))
            m = np.asarray(
                jax.random.normal(jax.random.fold_in(k, 3), (5, 5))
            ).astype(complex)
            r0s.append((m + m.T) / 2)
        As, r0s = jnp.asarray(np.stack(As)), jnp.asarray(np.stack(r0s))
        e64, _ = host_f64_sweep_energies(
            As, r0s, tfim_h64_batch(gvals), power_iters=2, max_iters=4
        )
        h = tfim_h64_batch(gvals)
        A_host = device_to_host_c128(As)
        for b in range(2):
            assert abs(e64[b] - _dense_energy(A_host[b], h[b])) < 1e-9


class TestGaugeFree:
    def test_matches_dense_mirror(self, key):
        """host_energy_gauge_free (ARPACK path, used by the VUMPS bench
        rows) against the dense mirror on a NON-canonical tensor — the
        gauge-free claim is exactly that canonicality is not assumed."""
        A = iMPS.random(key, 2, 6)[0]  # not canonicalised
        A = A / jnp.sqrt(jnp.sum(jnp.abs(A) ** 2))  # tame the scale only
        h = tfim_h64_batch(np.array([1.0]))[0]
        e = host_energy_gauge_free(A, h)
        assert abs(e - _dense_energy(device_to_host_c128(A), h)) < 1e-9

    def test_f32_ref_guard(self, key):
        """The chip-consistency guard (added after the deep-brickwork
        plateau probe watched the identity-start fixed point land on a
        wrong eigenvector and report err -0.72 against a chip readout of
        +7.4e-4): a consistent f32_ref passes the value through
        unchanged; an inconsistent one must yield NaN, never a
        confident wrong number."""
        A = iMPS.random(key, 2, 6)[0]
        A = A / jnp.sqrt(jnp.sum(jnp.abs(A) ** 2))
        h = tfim_h64_batch(np.array([1.0]))[0]
        e = host_energy_gauge_free(A, h)
        e_ok = host_energy_gauge_free(A, h, f32_ref=e + 1e-4)
        assert abs(e_ok - e) < 1e-9
        e_bad = host_energy_gauge_free(A, h, f32_ref=e + 1.0)
        assert np.isnan(e_bad)
