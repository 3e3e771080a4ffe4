"""The port's classifier train step held to the JAX package's, step by
step, on the CPU, through ``tools/compare_packages.py``'s harness: both
packages start from the JAX package's initial weights and see the same
batches and the same dropout masks (the harness substitutes the masks in
both heads; nothing in either package changes).

The trajectory: ``config.modelnet40()`` cut to B=4, N=1024 of 2048
points, k=3, 16 nodes, som_k 9, F=64, 4 classes, float32, at the
preset's learning rate (1e-3) and dropout (0.7), on a tree of the
port's ModelNet generator (nodes from its ``prep som``) with the
device pipeline's augmentation.  The first PointNet's BatchNorms reduce
B·kN = 12,288 rows, above the 8,192 from which both packages take the
one-pass variance E[x²] - E[x]².  20 shapes in batches of 4 make 5 steps
an epoch, and 20 steps cross three epoch boundaries with
``lr_decay_step=1``: epochs 0 and 1 train at 1e-3, epoch 2 at 5e-4,
epoch 3 at 2.5e-4 (the reference halves after an epoch ends).

Step by step: before each step the port takes the JAX package's state
(weights, running statistics, Adam's moments and count), so each step's
difference is that step's own.  Run free, the two part by rounding
alone at this learning rate (``compare_packages.py trajectory`` measures
that drift against a chaos control).  The JAX step is compiled without
XLA's fusion pass (``compare_packages.JAX_COMPILES``): fused, its float32
gradient through ``KNNModule``'s max over the neighbours drops about 8%
of the maxima and moves that module's first layer and the first
PointNet's gradients by 40% from the package's own unjitted gradient,
which the port's matches.

Tolerances, and why (measured, largest over the 20 steps):
* loss: 5e-5 relative -- the same float32 forward summed in another
  order (9e-6).
* the update (weights after the step minus before), by the norm of the
  difference over the norm of the JAX update: 0.1 -- Adam divides each
  gradient by its own size, so entries whose gradients sit at rounding
  level step by +-lr on either side (3.4e-2 at step 0, within 1.5e-2
  after; the port against itself from weights one ulp apart reads
  1.3e-2 to 3.6e-2).  A step at twice the rate reads 1.
* the same over the kNN layer's parameters alone: 0.1 (3.1e-2), and
  over the first PointNet's: 0.2 (6.7e-2).  A departure confined to
  them is diluted in the whole model's update; the fused JAX step's
  reads 0.47 and 0.71 there at step 0.
* the running statistics' update, likewise: 5e-5 (7e-6).

The one-pass variance: its rounding differs between the two packages'
summation orders as much as it differs from the two-pass form's, so no
tolerance on ordinary data tells the forms apart.  A second case makes
the first BatchNorm's input exact: box corners whose normals are axis
vectors, read by a first kernel of multiples of 1/2 (its rows for the
decentered points 0), and k=4 so that B·kN = 16,384 is a power of two
(XLA takes a mean as S * (1/n), torch as S / n: the same only when 1/n
is exact).  Every sum is then exact in float32 and both packages'
one-pass statistics agree bit for bit after the step, while the two-pass
form's differ by about 12 ulps.

Planted faults that must fail: the two-pass variance at every row count,
the learning rate halved one epoch late, and the JAX step compiled with
XLA's fusion (the maxima it drops).  And the repair of a
departure found here: the port's dropout divided a bfloat16 activation
by 1 - rate in float32, where flax divides by 1 - rate rounded to
bfloat16 (0.30078125 for rate 0.7).
"""

import contextlib
import io
import math
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import compare_packages as cp  # noqa: E402
import torch_make_modelnet_scale  # noqa: E402
from sonet_tpu import config as jconfig  # noqa: E402
from sonet_torch import config as tconfig  # noqa: E402
from sonet_torch.data.modelnet import ModelNetDataset  # noqa: E402
from sonet_torch.nn import layers as tl  # noqa: E402
from sonet_torch.train import state as tstate  # noqa: E402

torch.set_num_threads(2)

STEPS, SPE = 20, 5
OVER = dict(batch_size=4, input_pc_num=1024, k=3, node_num=16, som_k=9,
            feature_num=64, classes=4, lr_decay_step=1,
            compute_dtype="float32")
LOSS_RTOL, UPDATE_RTOL, STATS_RTOL = 5e-5, 0.1, 5e-5
# the update of the modules that learn only through KNNModule's max
SUBTREE_RTOL = {"knnlayer": 0.1, "first_pointnet": 0.2}
EXACT_BN = "first_pointnet/PointLayer_0/BatchNorm_0"
EXACT_ULPS = 2


def _configs(**over):
    o = dict(OVER, **over)
    return jconfig.modelnet40().replace(**o), tconfig.modelnet40().replace(**o)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 classes of 5 train shapes of 2048 points, 4x4 nodes fitted by
    the port's ``prep som`` on the CPU."""
    from sonet_torch.data import prep
    root = str(tmp_path_factory.mktemp("trajectory") / "mn")
    with contextlib.redirect_stdout(io.StringIO()):
        torch_make_modelnet_scale.main(
            ["--out", root, "--classes", "4", "--train_per_class", "5",
             "--test_per_class", "1", "--points", "2048", "--hardness",
             "0.15"])
        prep.main(["som", "--root", root, "--rows", "4", "--batch", "24",
                   "--som_sample", "1024", "--device", "cpu"])
    return root


def _tree_inputs(root):
    jc, tc = _configs(dataroot=root)
    train = ModelNetDataset(root, "train", tc)
    assert len(train) // tc.batch_size == SPE
    return jc, tc, cp.SharedInputs(train.raw_item, len(train), tc, SPE)


@pytest.fixture(scope="module")
def run(tree):
    """The JAX package's 20 steps and the port's from each of their
    states, on the tree as it stands."""
    jc, tc, inputs = _tree_inputs(tree)
    with cp.shared_dropout():
        return cp.run_steps(jc, tc, inputs, STEPS, compile="unfused")


def _update_error(row, prefix):
    """||update_torch - update_jax|| / ||update_jax|| over ``prefix``."""
    before, (_, jv), (_, tv) = row["before"], row["jax"], row["torch"]
    num = den = 0.0
    for k in jv:
        if k.startswith(prefix):
            dj = jv[k].astype(np.float64) - before[k]
            dt = tv[k].astype(np.float64) - before[k]
            num += float(np.sum((dt - dj) ** 2))
            den += float(np.sum(dj ** 2))
    return math.sqrt(num / den)


def _failures(rows):
    """Every check a row fails, as (step, check, value)."""
    out = []
    for r in rows:
        lj, lt = r["jax"][0], r["torch"][0]
        if abs(lt - lj) > LOSS_RTOL * abs(lj):
            out.append((r["step"], "loss", abs(lt - lj) / abs(lj)))
        checks = [("update", "params/", UPDATE_RTOL),
                  ("stats", "batch_stats/", STATS_RTOL)]
        checks += [(f"update {name}", f"params/encoder/{name}/", tol)
                   for name, tol in SUBTREE_RTOL.items()]
        for check, prefix, tol in checks:
            e = _update_error(r, prefix)
            if e > tol:
                out.append((r["step"], check, e))
    return out


def test_port_steps_hold_to_the_jax_steps(run):
    rows, _ = run
    assert [r["step"] for r in rows] == list(range(STEPS))
    # the JAX side crossed its halvings: epoch 3's updates are smaller
    # than epoch 0's (Adam's steps scale with the rate)
    norms = [math.sqrt(sum(float(np.sum((r["jax"][1][k].astype(np.float64)
                                         - r["before"][k]) ** 2))
                           for k in r["before"] if k.startswith("params/")))
             for r in rows]
    assert np.mean(norms[3 * SPE:]) < 0.5 * np.mean(norms[:SPE])
    assert _failures(rows) == []


def _late_halving(lr0, decay_step_epochs, ratio, clip, steps_per_epoch):
    """The halving schedule one epoch late."""
    def schedule(step):
        epoch = step // max(steps_per_epoch, 1)
        halvings = max(epoch - 2, 0) // max(decay_step_epochs, 1)
        return max(lr0 * ratio ** halvings, clip)
    return schedule


def test_planted_late_halving_fails(run, tree, monkeypatch):
    monkeypatch.setattr(tstate, "halving_schedule", _late_halving)
    jc, tc, inputs = _tree_inputs(tree)
    with cp.shared_dropout():
        rows, _ = cp.run_steps(jc, tc, inputs, STEPS, record=run[1])
    fails = _failures(rows)
    # from the first step of epoch 2, where the JAX side halves
    assert min(f[0] for f in fails if f[1] == "update") == 2 * SPE
    assert all(f[0] >= 2 * SPE for f in fails)


def test_planted_fused_jax_step_fails(tree):
    """The JAX step compiled as the package's train loop compiles it, with
    XLA's fusion: its float32 gradient through ``KNNModule``'s max over
    the neighbours drops about 8% of the maxima, and the checks of the kNN
    layer's and the first PointNet's updates refuse it from the first
    step."""
    jc, tc, inputs = _tree_inputs(tree)
    with cp.shared_dropout():
        rows, _ = cp.run_steps(jc, tc, inputs, SPE, compile="jit")
    failed = {f[:2] for f in _failures(rows)}
    assert {(0, f"update {name}") for name in SUBTREE_RTOL} <= failed


# -- the one-pass variance, on an exactly summed BatchNorm -------------------

N_RAW, T_CORNERS = 2048, 4


def _corner(i):
    """Item ``i``: a box corner, three faces of N_RAW points in all,
    each point's normal its face's axis; nodes on the faces."""
    rs = np.random.RandomState(100 + i)
    face = rs.randint(0, 3, N_RAW)
    pc = rs.uniform(0.0, 1.0, (N_RAW, 3)) * rs.uniform(0.5, 1.5, 3)
    pc[np.arange(N_RAW), face] = 0.0
    node = pc[rs.choice(N_RAW, OVER["node_num"], replace=False)]
    return {"pc": pc.astype(np.float32),
            "sn": np.eye(3, dtype=np.float32)[face],
            "node": (node + 0.02 * rs.randn(*node.shape)).astype(np.float32),
            "label": np.int64(i % 4)}


def _exact_first_layer(variables):
    """The first PointNet's first kernel reads only the normals (its rows
    for the decentered points 0) through weights c + d, c in 12..15 and
    d in {-1/2, 0, 1/2}: every pre-activation is a multiple of 1/2 below
    16, every sum of them or of their squares over the 16,384 rows exact
    in float32."""
    key = "params/encoder/first_pointnet/PointLayer_0/Dense_0/kernel"
    k = variables[key].copy()
    rs = np.random.RandomState(7)
    k[:3] = 0.0
    k[3:6] = (rs.randint(24, 31, k.shape[1])
              + rs.randint(-1, 2, (3, k.shape[1]))) * 0.5
    return dict(variables, **{key: k.astype(np.float32)})


@pytest.fixture(scope="module")
def exact():
    """One step on box corners from the exact first layer (k=4: B·kN =
    16,384); returns the inputs and the JAX record."""
    jc, tc = _configs(k=4)
    items = [_corner(i) for i in range(T_CORNERS)]
    inputs = cp.SharedInputs(lambda i: items[i], T_CORNERS, tc, 1,
                             augment=False)   # the normals stay axis vectors
    with cp.shared_dropout():
        rows, record = cp.run_steps(jc, tc, inputs, 1,
                                    adjust=_exact_first_layer,
                                    compile="unfused")
    return jc, tc, inputs, rows, record


def _exact_ulps(row):
    """The exactly summed BatchNorm's running statistics after the step:
    the largest difference between the packages, in ulps."""
    (_, jv), (_, tv) = row["jax"], row["torch"]
    worst = 0.0
    for leaf in ("mean", "var"):
        k = f"batch_stats/encoder/{EXACT_BN}/{leaf}"
        worst = max(worst, float(np.max(np.abs(tv[k] - jv[k])
                                        / np.spacing(np.abs(jv[k])))))
    return worst


def test_the_exact_batchnorm_agrees_bit_for_bit(exact):
    rows = exact[3]
    assert _exact_ulps(rows[0]) == 0.0


def _two_pass(self, x, epoch=None):
    """The port's BatchNorm with the two-pass variance at every row count
    (one process)."""
    xf = x.float()
    if self.training:
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(axes)
        var = (xf - mean).square().mean(axes)
        self._update_running(mean, var, math.prod(x.shape[:-1]), epoch)
    else:
        mean, var = self.running_mean, self.running_var
    y = (xf - mean) * torch.rsqrt(var + self.eps)
    return (y * self.weight + self.bias).to(x.dtype)


def test_planted_two_pass_variance_fails(exact, monkeypatch):
    monkeypatch.setattr(tl.BatchNorm, "forward", _two_pass)
    jc, tc, inputs, _, record = exact
    with cp.shared_dropout():
        rows, _ = cp.run_steps(jc, tc, inputs, 1, record=record)
    assert _exact_ulps(rows[0]) > 4 * EXACT_ULPS


# -- the departure repaired: dropout's scale in bfloat16 ---------------------

@pytest.mark.parametrize("rate", [0.7, 0.6, 0.5])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dropout_scales_as_flax(dtype, rate):
    """The port's dropout, given flax's mask, gives flax's output bit for
    bit: in bfloat16 the keep probability is rounded to bfloat16 before
    the division, as flax's weakly typed constant is."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from sonet_torch.nn.heads import apply_dropout
    x = np.random.RandomState(0).randn(64, 512).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = nn.Dropout(rate).apply({}, xj, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(1)})
    keep = torch.from_numpy(np.asarray(want) != 0)
    got = apply_dropout(torch.from_numpy(x).to(getattr(torch, dtype)), keep,
                        rate)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
