"""The port's Sim3 PGO (``ba/pgo.py``): ports of ``test_pgo.py``, and
``run_pgo`` against the JAX package's on a 20-keyframe ring with two loop
edges.

The port solves in float64 whatever its inputs' type (``ba/pgo.py``), so
it is held to the JAX solve run under ``jax.enable_x64``: 1e-6 per
component of the corrected (n, 8) Sim3 poses (they agree to 1e-8 or
better). The JAX package's own float32 solve is shown to wander (the
last test): its accept/reject decisions differ from float64's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.ba import pgo as jpgo
from cdvslam_tpu_torch.ba.pgo import perform_updates, run_pgo
from cdvslam_tpu_torch.lie import SE3, se3_exp, se3_inv, se3_mul, se3_to_sim3, sim3_inv, sim3_mul

torch.set_num_threads(2)


def _drifted(gt, noise, rng):
    """Integrate noisy relative motions of the ground truth (world->cam)."""
    est = [gt[0]]
    for i in range(1, len(gt)):
        rel = se3_mul(gt[i], se3_inv(gt[i - 1]))
        rel = se3_mul(SE3.exp(torch.tensor(noise * rng.randn(6), dtype=gt.dtype)).data, rel)
        est.append(se3_mul(rel, est[-1]))
    return torch.stack(est)


def test_pgo_closes_loop():
    """Drifted chain + perfect loop constraint -> the constraint holds."""
    n = 20
    rng = np.random.RandomState(0)
    gt = torch.zeros((n, 7))
    gt[:, 6] = 1.0
    th = torch.linspace(0, 2 * np.pi, n)
    gt[:, 0] = torch.sin(th)
    gt[:, 2] = 1 - torch.cos(th)
    est = _drifted(gt, 0.02, rng)
    # the PHYSICAL relative Sim3 mapping points in cam_{n-1}'s frame to
    # cam_0's frame, C = G_0 G_{n-1}^-1 with G = world->cam
    C = sim3_mul(se3_to_sim3(gt[0]), sim3_inv(se3_to_sim3(gt[n - 1])))[None]
    out = perform_updates(est, C, np.array([n - 1]), np.array([0]), iters=30)
    rel = sim3_mul(out[0], sim3_inv(out[n - 1]))
    err = float((rel - C[0].double()).abs().max())
    assert err < 2e-2, f"loop constraint violated by {err}"
    assert not torch.isnan(out).any()


def test_pgo_wrong_frame_convention_is_detected():
    """The physical measurement recovers the true relative pose (not one in
    a conjugated frame) on a large-rotation trajectory, where the
    conjugation error would be about 2 rad."""
    n = 16
    rng = np.random.RandomState(1)
    th = 2 * np.pi * np.arange(n) / (n - 1)
    xi = np.stack([np.sin(th), 0 * th, 1 - np.cos(th), 0 * th, th, 0 * th], 1)
    gt = se3_exp(torch.tensor(xi, dtype=torch.float32))
    est = _drifted(gt, 0.03, rng)
    C = sim3_mul(se3_to_sim3(gt[0]), sim3_inv(se3_to_sim3(gt[n - 1])))[None]
    safe_i, out = run_pgo(est, C, np.array([n - 1]), np.array([0]), iters=40)
    assert safe_i == n
    rel = sim3_mul(out[0], sim3_inv(out[n - 1]))
    C = C.double()
    if torch.dot(rel[3:7], C[0, 3:7]) < 0:      # q and -q are one rotation
        rel[3:7] = -rel[3:7]
    assert float((rel - C[0]).abs().max()) < 5e-2


def ring(seed, noise, n=20):
    """A closed 20-keyframe ring (float64, world->cam), its drifted
    estimate and two loop edges (19 -> 0, 15 -> 3) measured on the truth."""
    rng = np.random.RandomState(seed)
    th = 2 * np.pi * np.arange(n) / n
    xi = np.stack([np.sin(th), 0.1 * np.sin(2 * th), 1 - np.cos(th), 0 * th, th, 0 * th], 1)
    gt = se3_exp(torch.tensor(xi, dtype=torch.float64))
    est = _drifted(gt, noise, rng)
    G = se3_to_sim3(gt)
    pairs = [(19, 0), (15, 3)]
    C = torch.stack([sim3_mul(G[j], sim3_inv(G[i])) for i, j in pairs])
    return est, C, np.array([i for i, _ in pairs]), np.array([j for _, j in pairs])


@pytest.mark.parametrize("seed,noise", [(0, 0.02), (2, 0.02), (5, 0.02), (1, 0.05)])
def test_run_pgo_matches_jax_in_float64(seed, noise):
    est, C, ii, jj = ring(seed, noise)
    with jax.enable_x64(True):
        j_safe, j_out = jpgo.run_pgo(est.numpy(), C.numpy(), ii, jj)
        j_out = np.asarray(j_out)
    t_safe, t_out = run_pgo(est, C, ii, jj)
    assert j_out.dtype == np.float64 and t_out.dtype == torch.float64
    assert j_safe == t_safe == 20
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=0, atol=1e-6)


def _jax_run_pgo64(est, C, ii, jj):
    with jax.enable_x64(True):
        return np.asarray(jpgo.run_pgo(est.double().numpy(), C.double().numpy(), ii, jj)[1])


def test_run_pgo_solves_float32_poses_in_float64():
    """The SLAM's float32 poses and measurements go in; the solve and its
    result are float64, JAX's float64 solve on the same values within 1e-6."""
    est, C, ii, jj = ring(0, 0.02)
    est, C = est.float(), C.float()
    _, out = run_pgo(est, C, ii, jj)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), _jax_run_pgo64(est, C, ii, jj), rtol=0, atol=1e-6)


def test_jax_float32_pgo_wanders_along_its_gauge():
    """The fault the port's float64 solve avoids (ROADMAP Queue 3): the
    system's gauge is damped only by lmbda (from 1e-6) and 1e-8, so float32
    rounding moves the state along it and flips the LM's accept/reject
    decisions; on this ring the JAX float32 solve ends 6.3e-2 from its
    float64 solve (more than 1e-2), which the port matches to 1e-6 (the
    tests above, same ring)."""
    est, C, ii, jj = ring(5, 0.02)
    j32 = np.asarray(jpgo.run_pgo(est.float().numpy(), C.float().numpy(), ii, jj)[1])
    assert np.abs(j32 - _jax_run_pgo64(est, C, ii, jj)).max() > 1e-2
