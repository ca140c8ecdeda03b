"""The port's data-parallel train step (`make_train_step(group=)`, under
`sharded_batch`) on 2 CPU ranks over gloo, against the one-process step on
the global batch (B=4, two clouds a rank, 128 points, fp32, one step from
the same seed's init).

Under the JAX package's sharded jit the train-mode BatchNorm statistics and
a loss's batch ratios are the global batch's. The port takes each rank's
sums between the kernel (or plain pass) that forms them and the affine step
that reads them: `batch_stats` (PointNet's Dense + BatchNorm layers and
STN heads), `DenseBNMaxPool`'s `dense_pool_stats` sums (PointNet's trunk),
the fused chain's per-layer sums and its backward's Sd / Se (PointNet2's
set abstractions), and `EarthMoverDistance`'s class shares and weighted
means (the Segmenter). Cases: those three configurations, and PointNet's
Chamfer and the Segmenter's EMD with RING_MIN_ELEMENTS patched low, so that
the loss takes the ring inside the step (each rank's clouds gathered into
the global batch, the point axis sharded over the ranks, each rank keeping
its clouds' values and matchings).

Held, for each case (rank 0 against the one-process step): the loss and
its logs within 1e-5; the gradients by tests/test_torch_train_slice.py's
rule (1e-3 relative plus 3e-3 of the tensor's largest entry, on every
entry but PointNet2's, of which 99.9% (SHARE below); the trap
biases of `zero_gradient_biases`, and tensors whose gradient is round-off
below 1e-6 of the largest one on both sides, held as round-off below 1e-4
of the largest gradient); the parameters after the Adam step within 2 lr
(the most that one Adam step of opposite sign on a round-off gradient puts
between two copies); the running statistics within 1e-5 (relative to
max(1, |value|)); and rank 1's loss, gradients and state bit-equal to rank
0's. A planted fault (the step without `sharded_batch`: statistics and
ratios each rank's own) moves PointNet's loss and the Segmenter's by more
than 10 times the tolerance (measured: 1.2e-4 and more).
"""

import numpy as np
import pytest
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from torch_dist_utils import calls, group_case, run_ranks, train_step_case

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.envs import scenes
from pointcloud_tpu_torch.train import harness

B, N = 4, 128
LOSS_TOL = 1e-5
LR = cfg.vision_lr
CASES = {
    "PointNet": ("Autoencoder", "PointNet", "chamfer"),
    "PointNet2": ("Autoencoder", "PointNet2", "chamfer"),
    "Segmenter-EMD": ("Segmenter", "PointNet", None),
    "PointNet-ring-route": ("Autoencoder", "PointNet", "chamfer"),
    "Segmenter-EMD-ring-route": ("Segmenter", "PointNet", None),
}
FAULTS = ("PointNet", "Segmenter-EMD")
# PointNet2's gradients are ill-conditioned in fp32 at 128 points: a 1e-6
# relative perturbation of the input moves 887 of SA3's 131,072 w1 entries
# past the rule in the one-process step itself (4.8e-4 of them 1e-7 does
# not). The ranks' order of sums moves 27 of the model's entries (measured):
# held on 99.9% of them.
SHARE = {"PointNet2": 0.999}


def batch(model_type, seed=0):
    """Global batch (x, y): clouds inside the Cube scene's box (xyz, rgb);
    the Segmenter's target xyz + a label over the scene's classes."""
    rng = np.random.default_rng(seed)
    bbox = np.asarray(scenes.scene_config("Cube").bbox, np.float32)
    x = rng.random((B, N, 6), dtype=np.float32)
    y = rng.random((B, N, 6), dtype=np.float32)
    for a in (x, y):
        a[..., :3] = bbox[:, 0] + a[..., :3] * (bbox[:, 1] - bbox[:, 0])
    if model_type == "Segmenter":
        n_cls = len(scenes.scene_config("Cube").classes)
        y = np.concatenate([y[..., :3], rng.integers(0, n_cls, (B, N, 1))
                            .astype(np.float32)], -1)
    return x, y


def case_args(name):
    model_type, backbone, loss = CASES[name]
    return (model_type, backbone, loss, *batch(model_type))


@pytest.fixture(scope="module")
def runs():
    """{case: (rank results, one-process result)}, {case: faulted rank 0}."""
    # train_step_case's positional tail: sample_points, emd_iters, seed,
    # ring_min, local_batch
    pairs = [(train_step_case, (*case_args(name), N, 10, 0,
                                1 if name.endswith("ring-route") else None, False))
             for name in CASES]
    pairs += [(train_step_case, (*case_args(name), N, 10, 0, None, True))
              for name in FAULTS]
    pairs.append((group_case, (B,)))
    ranks = run_ranks(calls, 2, *pairs)
    got = {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}
    faults = {name: ranks[0][len(CASES) + i] for i, name in enumerate(FAULTS)}
    one = {name: train_step_case(*case_args(name), N) for name in CASES}
    return ({name: (got[name], one[name]) for name in CASES}, faults, one,
            [r[-1] for r in ranks])


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_logs_are_the_global_batchs(runs, case):
    ranks, one = runs[0][case]
    assert ranks[0][4] and not one[4]  # rank 0 ran under a group, the reference not
    assert abs(ranks[0][0] - one[0]) <= LOSS_TOL, (ranks[0][0], one[0])
    assert set(ranks[0][1]) == set(one[1])
    for k, v in one[1].items():
        assert abs(ranks[0][1][k] - v) <= LOSS_TOL, k


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_are_the_global_batchs(runs, case):
    ranks, one = runs[0][case]
    got, want = ranks[0][2], one[2]
    model_type, backbone, loss = CASES[case]
    trap = harness.zero_gradient_biases(harness.create_model(
        model_type, backbone, "Cube", loss_override=loss, device="cpu").model)
    # (the trap's names do not depend on the point count)
    largest = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    bad, total = {}, 0
    for k, w in want.items():
        g = got[k]
        if k in trap or max(np.abs(w).max(), np.abs(g).max()) < 1e-6 * largest:
            assert np.abs(g).max() <= 1e-4 * largest and np.abs(w).max() <= 1e-4 * largest, k
            continue
        ok = np.abs(g - w) <= 1e-3 * np.abs(w) + 3e-3 * float(np.abs(w).max())
        total += ok.size
        if not ok.all():
            bad[k] = (int((~ok).sum()), float(np.abs(g - w).max()))
    assert sum(n for n, _ in bad.values()) <= (1 - SHARE.get(case, 1.0)) * total, bad


@pytest.mark.parametrize("case", list(CASES))
def test_parameters_after_the_step(runs, case):
    ranks, one = runs[0][case]
    for k in one[2]:  # the parameters
        np.testing.assert_allclose(ranks[0][3][k], one[3][k], rtol=0, atol=2 * LR,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_running_statistics_are_the_global_batchs(runs, case):
    ranks, one = runs[0][case]
    buffers = [k for k in one[3] if k not in one[2]]
    assert buffers
    for k in buffers:
        w = one[3][k]
        np.testing.assert_allclose(ranks[0][3][k], w, rtol=0,
                                   atol=LOSS_TOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_are_bit_equal(runs, case):
    (r0, r1), _ = runs[0][case]
    assert r0[0] == r1[0] and r0[1] == r1[1]
    for part in (2, 3):
        assert set(r0[part]) == set(r1[part])
        for k, v in r0[part].items():
            np.testing.assert_array_equal(v, r1[part][k], err_msg=k)


@pytest.mark.parametrize("case", FAULTS)
def test_local_statistics_are_caught(runs, case):
    _, faults, one, _ = runs
    assert abs(faults[case][0] - one[case][0]) > 10 * LOSS_TOL


def test_group_helpers_on_two_ranks(runs):
    """process_local_batch_slice, global_mesh (a 1-D DeviceMesh over the
    default group), shard_batch of a dict batch and data_mesh's refusal of
    a global batch that does not divide the ranks."""
    x = np.arange(B * 2).reshape(B, 2)
    for rank, (sl, size, group_size, shard, refused) in enumerate(runs[3]):
        assert sl == slice(rank * B // 2, (rank + 1) * B // 2)
        assert size == group_size == 2 and refused
        np.testing.assert_array_equal(shard["x"], x[sl])
        np.testing.assert_array_equal(shard["y"][0], np.arange(B)[sl])
