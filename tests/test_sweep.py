"""Sharded sweeps on the 8-device virtual CPU mesh (BASELINE config 4
machinery)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmps_tpu.ham import tfim_gs_energy
from qmps_tpu.parallel import make_mesh, phase_diagram_sweep, sweep_ground_states


@pytest.mark.slow
def test_vmapped_sweep_energies():
    """Slow suite: test_refine_passes_only_improve asserts the same
    accuracy bar through the same call path in the fast half."""
    gs = jnp.linspace(0.2, 2.0, 8)
    es, params = sweep_ground_states(gs, D=2, steps=250)
    exact = np.asarray(tfim_gs_energy(gs))
    err = np.asarray(es) - exact
    assert np.all(err > -1e-8)
    assert np.max(err) < 5e-3


@pytest.mark.slow
def test_sharded_sweep_matches_vmap():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(8)
    gs = jnp.linspace(0.2, 2.0, 16)
    es_sharded, _ = sweep_ground_states(gs, D=2, steps=120, mesh=mesh)
    es_local, _ = sweep_ground_states(gs, D=2, steps=120)
    np.testing.assert_allclose(np.asarray(es_sharded), np.asarray(es_local), atol=1e-9)


def test_sharded_deep_bw_sweep_matches_vmap():
    """Regression: the recycled deep-brickwork per-point optimizer carries
    a replicated identity environment through its scan; under shard_map's
    varying-manual-axes check that start must be pcast to the shard's
    varying type (mps/transfer._match_vma) or the program fails to trace
    — caught by the round-4 multichip dryrun."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    gs = jnp.linspace(0.5, 1.5, 16)
    es_sharded, _ = sweep_ground_states(
        gs, D=4, ansatz="deep_bw", steps=3, mesh=make_mesh(8)
    )
    es_local, _ = sweep_ground_states(gs, D=4, ansatz="deep_bw", steps=3)
    np.testing.assert_allclose(
        np.asarray(es_sharded), np.asarray(es_local), atol=1e-9
    )


def test_multi_start_ground_state():
    from qmps_tpu.parallel.sweep import multi_start_ground_state

    e, p = multi_start_ground_state(1.0, D=2, ansatz="full15", n_starts=8, steps=200)
    assert float(e) - float(tfim_gs_energy(1.0)) < 2e-2
    assert p.shape == (15,)


def test_hamiltonian_matrices_are_host_numpy():
    """Constants captured into jits must be host arrays (they embed into
    the program as literals; a device array would be fetched at trace
    time)."""
    import numpy as np

    from qmps_tpu.ham import tfim
    from qmps_tpu.ham.hamiltonian import as_host_matrix, scars_H

    assert isinstance(tfim(1.0).to_matrix(), np.ndarray)
    assert isinstance(scars_H(0.3), np.ndarray)
    assert isinstance(as_host_matrix(tfim(0.5)), np.ndarray)


def test_phase_diagram_multi_D():
    gs = jnp.linspace(0.5, 1.5, 8)
    table = phase_diagram_sweep(gs, Ds=(2,), steps=150, mesh=make_mesh(8))
    assert table.shape == (1, 8)
    assert np.all(np.isfinite(np.asarray(table)))


def test_refine_passes_only_improve():
    """Adiabatic-continuation refinement never worsens any point and
    rescues bad basins (elementwise best is kept)."""
    from qmps_tpu.ham import tfim_gs_energy

    gs = jnp.linspace(0.3, 1.8, 16)
    e0, p0 = sweep_ground_states(gs, D=2, steps=100)
    e1, p1 = sweep_ground_states(gs, D=2, steps=100, refine_passes=1)
    assert np.all(np.asarray(e1) <= np.asarray(e0) + 1e-12)
    exact = np.asarray(tfim_gs_energy(np.asarray(gs, np.float64)))
    assert np.max(np.asarray(e1, np.float64) - exact) < 5e-3


def test_refine_verbatim_eval_mechanism():
    """The refine pass's two guarantees: (a) the evaluator reproduces the
    optimizer's reported energy at the returned parameters (so the
    elementwise min across passes compares like with like), and (b) the
    verbatim-neighbor hop has small excess energy (ground-state continuity
    in g) — the property that heals ATTRACTIVE bad basins which full
    re-optimization from a warm start falls back into."""
    from qmps_tpu.parallel.sweep import _SWEEP_CACHE

    gs = jnp.linspace(0.3, 1.8, 16)
    # D=4 needs enough steps to CONVERGE the ferromagnetic-side points:
    # below g=1 the optimum is the symmetry-broken state and an
    # unconverged iterate can sit near transfer-spectrum degeneracy,
    # where the optimizer's warm 200-iter solve and the evaluator's cold
    # identity-start solve legitimately disagree (~3e-3 measured at 60
    # steps) — the (a) guarantee is a statement about converged returns
    for D, steps in ((2, 100), (4, 150)):
        es, ps = sweep_ground_states(gs, D=D, steps=steps)
        key = next(k for k in _SWEEP_CACHE if k[0] == D and k[2] == steps)
        _, eval_fn = _SWEEP_CACHE[key]
        # (a) evaluator == optimizer's final reported energy (the recycled
        # path's final solve starts warm vs. the evaluator's cold identity
        # start — agreement is set by the 200-iter solve, not exactness)
        e_eval = np.asarray(eval_fn(gs, ps), np.float64)
        np.testing.assert_allclose(e_eval, np.asarray(es, np.float64), atol=1e-5)
        # (b) continuity: a converged neighbor's params cost O(dg^2) here
        e_nb = np.asarray(eval_fn(gs, jnp.roll(ps, 1, axis=0)), np.float64)
        interior = (e_nb - np.asarray(es, np.float64))[1:]  # drop the wrap
        assert np.median(interior) < 5e-3, interior


def test_shard_over_sweep_identity_and_mesh():
    """shard_over_sweep is the identity without a mesh and a pure layout
    change with one (multi-output functions included)."""
    from qmps_tpu.parallel import make_mesh
    from qmps_tpu.parallel.mesh import shard_over_sweep

    def f(a, b):
        return a * 2 + b, (a - b).sum(axis=-1)

    assert shard_over_sweep(f, None) is f
    a = jnp.arange(16.0).reshape(8, 2)
    b = jnp.ones((8, 2))
    x0, y0 = f(a, b)
    x1, y1 = jax.jit(shard_over_sweep(f, make_mesh()))(a, b)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0))
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y0))


def test_fused_sweep_smoke():
    """sweep_ground_states_fused runs end to end on the virtual mesh box:
    finite energies, left-canonical returned tensors, restart reduction."""
    from qmps_tpu.parallel.sweep import sweep_ground_states_fused

    # same shapes/steps as test_fused_sweep_sharded_matches_unsharded so
    # the two tests share every compiled program (the sweep cache keys on
    # (engine, steps-chunking, mesh) and jit retraces on the point count)
    gs = jnp.linspace(0.5, 1.5, 8)
    # engine="xla": the sweep wrapper logic (projection, polar retraction,
    # chunking, restart reduction) without the interpret-mode kernel
    # compile; the pallas engine is covered by the slow test + on-chip
    es, As = sweep_ground_states_fused(
        gs, steps=20, restarts=2, chunk=10, engine="xla"
    )
    assert es.shape == (8,) and As.shape == (8, 2, 2, 2)
    assert np.all(np.isfinite(np.asarray(es)))
    A = np.asarray(As)
    lc = np.einsum("bsik,bsij->bkj", A.conj(), A)
    np.testing.assert_allclose(lc, np.broadcast_to(np.eye(2), lc.shape), atol=1e-10)


@pytest.mark.slow
def test_fused_sweep_converges_to_exact():
    """The fused Riemannian sweep lands on the exact TFIM integral to the
    same tolerance class as the suN-chart sweep."""
    from qmps_tpu.ham import tfim_gs_energy
    from qmps_tpu.parallel.sweep import sweep_ground_states_fused

    gs = jnp.linspace(0.3, 1.8, 12)
    es, _ = sweep_ground_states_fused(gs, steps=220, restarts=2)
    exact = np.asarray(tfim_gs_energy(np.asarray(gs, np.float64)))
    err = np.asarray(es, np.float64) - exact
    assert np.all(err > -1e-9), err  # variational: never below exact
    assert np.median(err) < 5e-4, err
    assert np.max(err) < 5e-3, err


def test_fused_sweep_sharded_matches_unsharded():
    """Fused sweep over the 8-device virtual mesh == single-device (pure
    data parallelism over points x restarts; engine='xla' keeps the
    fast-suite compile cheap — the sharding structure is identical)."""
    from qmps_tpu.parallel import make_mesh
    from qmps_tpu.parallel.sweep import sweep_ground_states_fused

    gs = jnp.linspace(0.5, 1.5, 8)
    kw = dict(steps=20, restarts=2, chunk=10, engine="xla")
    e1, A1 = sweep_ground_states_fused(gs, **kw)
    e2, A2 = sweep_ground_states_fused(gs, mesh=make_mesh(), **kw)
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(A1), np.asarray(A2), atol=1e-12)


def test_grow_su_params_exact_identity():
    """kron(SU(v, N), I2) == SU(grow(v), 2N) EXACTLY (not just for small
    v): growth in the expm chart is the linear map coeffs(kron(H, I2)),
    since kron(A, I)^k = kron(A^k, I) term-by-term in the exponential.
    Also pins agreement with the original logm-based embed_su_params and
    the batched shape contract."""
    from qmps_tpu.core import lie

    rng = np.random.default_rng(7)
    v = rng.normal(size=15) * 0.4  # su(4): a D=2 state unitary
    v8 = lie.grow_su_params(v, eps=0.0)
    assert v8.shape == (63,)
    U = np.asarray(lie.SU(jnp.asarray(v), 4))
    U8 = np.asarray(lie.SU(jnp.asarray(v8), 8))
    np.testing.assert_allclose(U8, np.kron(U, np.eye(2)), atol=1e-10)
    # matches the logm route away from its branch cut (small v)
    np.testing.assert_allclose(
        lie.grow_su_params(0.1 * v, eps=4e-2),
        lie.embed_su_params(0.1 * v, eps=4e-2),
        atol=1e-8,
    )
    # batched: (n, k, 15) -> (n, k, 63), rows independent
    vs = rng.normal(size=(3, 2, 15))
    out = lie.grow_su_params(vs, eps=1e-3)
    assert out.shape == (3, 2, 63)
    np.testing.assert_allclose(out[1, 0], lie.grow_su_params(vs[1, 0], eps=1e-3))


@pytest.mark.slow
def test_grown_sweep_heals_bad_basins():
    """Bond-growth continuation (sweep_ground_states_grown): every D=4
    point warm-starts inside its D=2 optimum's basin, so the grown sweep
    is (a) variational, (b) at least as good pointwise as its own D=2
    rung, and (c) free of the random-start outliers."""
    from qmps_tpu.parallel.sweep import sweep_ground_states_grown

    gs = jnp.linspace(0.4, 1.8, 6)
    es4, ps4, stages = sweep_ground_states_grown(
        gs, D=4, steps=200, stage_steps=200, return_stages=True
    )
    assert set(stages) == {2, 4}
    exact = np.asarray(tfim_gs_energy(np.asarray(gs, np.float64)))
    err = np.asarray(es4, np.float64) - exact
    assert np.all(err > -1e-9), err
    assert np.max(err) < 2e-3, err
    # up the ladder: D=4 grown never loses to its D=2 rung beyond adam's
    # convergence-noise margin (the start is exact; the final iterate is
    # not monotone), and it heals the D=2 rung's worst point outright
    e2 = np.asarray(stages[2][0], np.float64)
    assert np.all(np.asarray(es4, np.float64) <= e2 + 5e-4)
    assert np.max(err) < np.max(e2 - exact)
    assert ps4.shape == (6, 63)
