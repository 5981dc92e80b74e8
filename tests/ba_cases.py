"""Bundle-adjustment problems at the SLAM's shapes, shared by the BA
kernel tests (``test_torch_ba.py`` on the CPU, ``test_torch_cuda.py`` on
the card).

``ba_case`` builds a window like the main path's: NF frames of a camera
moving along x, M patches a frame (the patch window K = NF * M), E real
edges between frames up to six apart padded to E_pad with masked edges,
targets at the projections plus a pixel of noise, and the last N frames
optimized (t0 = NF - N, or later with ``past_end`` window rows beyond the
pose buffer). ``edge_cases`` mixes in what the gate and the clamps exist
for: masked real edges, negative inverse depths (Z below z_min),
residuals over 128 px, projections outside the margin and NaN weights
(``nan_weight``). ``update_case`` gives the step's inputs: dX with zero,
small-angle (under 1e-6 rad) and large rows, dZ that sends depths past 20
and below 0, and untouched patches. Everything comes from a CPU generator
and is then moved to ``dev``.
"""
import torch

from cdvslam_tpu_torch.ba.ba import _edge_terms
from cdvslam_tpu_torch.lie import se3_exp

# the main path's shapes (480 x 752: POSE_WINDOW 16, 96 patches, KWIN 2,688)
SHAPES = {"cdvo": 10240, "dpvo": 12288, "cdvopp": 16384}


def ba_case(dev, E_pad=10240, E=9600, N=16, NF=28, M=96, P=3, seed=0, edge_cases=False,
            nan_weight=False, past_end=0):
    g = torch.Generator().manual_seed(seed)
    K = NF * M
    xi = 0.05 * torch.randn((NF, 6), generator=g)
    xi[:, 0] += 0.05 * torch.arange(NF)
    poses = se3_exp(xi)
    patches = torch.zeros((K, 3, P, P))
    patches[:, 0] = (4 + torch.rand(K, generator=g) * 180)[:, None, None]
    patches[:, 1] = (4 + torch.rand(K, generator=g) * 110)[:, None, None]
    patches[:, 2] = (0.2 + 1.5 * torch.rand(K, generator=g))[:, None, None]
    intr = torch.tensor([115.0, 115.0, 94.0, 60.0])
    kk = torch.randint(0, K, (E,), generator=g)
    ii = kk // M
    jj = (ii + torch.randint(-6, 7, (E,), generator=g)).clamp(0, NF - 1)
    if edge_cases:
        far = torch.rand(K, generator=g)
        patches[far < 0.02, 2] = -20.0                     # behind the camera
        patches[(far > 0.02) & (far < 0.04), 0] = -400.0    # outside the margin
        patches[(far > 0.04) & (far < 0.05), 1] = 900.0
    r = _edge_terms(poses, patches, intr, torch.zeros((E, 2)), ii, jj, kk, 0.2)[0]
    target = -r + torch.randn((E, 2), generator=g)
    weight = torch.rand((E, 2), generator=g)
    mask = torch.ones(E, dtype=torch.bool)
    if edge_cases:
        pick = torch.rand(E, generator=g)
        target[pick < 0.01] += 300.0                        # residual over 128 px
        mask[(pick > 0.01) & (pick < 0.02)] = False
        if nan_weight:
            weight[(pick > 0.02) & (pick < 0.025), 1] = float("nan")
    pad = E_pad - E
    zeros = torch.zeros(pad, dtype=torch.long)
    case = {"poses": poses, "patches": patches, "intrinsics": intr,
            "target": torch.cat([target, torch.zeros((pad, 2))]),
            "weight": torch.cat([weight, torch.zeros((pad, 2))]),
            "ii": torch.cat([ii, zeros]), "jj": torch.cat([jj, zeros]),
            "kk": torch.cat([kk, zeros]),
            "mask": torch.cat([mask, torch.zeros(pad, dtype=torch.bool)])}
    case = {k: v.to(dev) for k, v in case.items()}
    case.update(t0=NF - N + past_end, N=N, K=K)
    return case


def solve_args(case):
    """``ba_solve``'s positional arguments and keywords for a case."""
    c = case
    return ((c["poses"], c["patches"], c["intrinsics"], c["target"], c["weight"], c["ii"],
             c["jj"], c["kk"], c["mask"], c["t0"]), {"N": c["N"], "K": c["K"]})


def update_case(case, seed=0):
    """(dX (6N,), dZ (K,), touched (K,) bool, win_rows (N,) int64) for a case's
    window, on its device."""
    g = torch.Generator().manual_seed(seed + 1)
    N, K, NP = case["N"], case["K"], case["poses"].shape[0]
    dX = 0.01 * torch.randn((N, 6), generator=g)
    dX[0] = 0.0                                  # a failed solve's zeros
    dX[1, 3:] = 1e-8 * torch.randn(3, generator=g)   # the small-angle branch
    dX[2] = torch.randn(6, generator=g)          # a large step
    dZ = 0.1 * torch.randn(K, generator=g)
    pick = torch.rand(K, generator=g)
    dZ[pick < 0.02] = 50.0                       # past 20: reset to 1
    dZ[(pick > 0.02) & (pick < 0.04)] = -5.0     # below the floor
    touched = torch.rand(K, generator=g) > 0.1
    win = torch.arange(N) + case["t0"]
    win_rows = torch.where(win < NP, win, torch.full_like(win, NP))
    dev = case["poses"].device
    return dX.reshape(-1).to(dev), dZ.to(dev), touched.to(dev), win_rows.to(dev)
