"""The plain reference agrees with the program's CPU path at small sizes
(the program's kernels take their plain versions on CPU tensors, in
float32): the parameter layout, the eval forward, the first train step's
loss and gradients, and the sensor's chain."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import core, scene
from portbench import reference as R

CONFIGS = ["ae_pointnet2_chamfer", "ae_pointnet_emd"]


def program(cfg):
    from pointcloud_tpu_torch.train.harness import create_model

    return create_model(cfg["model_type"], cfg["backbone"], cfg["scene"],
                        loss_override=cfg["loss_override"], device="cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_and_eval(name):
    from pointcloud_tpu_torch.train.harness import make_eval_step

    cfg = core.load_json("configs", name)
    spec = program(cfg)
    sd = spec.model.state_dict()
    assert {n: tuple(s) for n, s, _ in R.param_specs(cfg)} == {
        n: tuple(t.shape) for n, t in sd.items()}
    raw = torch.from_numpy(scene.render(np.random.default_rng(7), 2, cfg["points"]))
    w = R.calibrate_statistics(cfg, R.make_weights(cfg, 7, "cpu"), raw)
    spec.model.load_state_dict(w, strict=True)
    loss, _, out = make_eval_step(spec)(raw, raw)
    ref_loss, ref_out = R.eval_step(cfg, w, raw)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    z = spec.model.encode(R.normalize(raw, cfg["bbox"]))
    torch.testing.assert_close(z, R.encode(w, cfg, R.normalize(raw, cfg["bbox"])),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_first_train_step(name):
    from pointcloud_tpu_torch.train.harness import make_optimizer, make_train_step

    cfg = core.load_json("configs", name)
    spec = program(cfg)
    w = R.make_weights(cfg, 8, "cpu")
    spec.model.load_state_dict(w, strict=True)
    opt = make_optimizer(spec)
    raw = torch.from_numpy(scene.render(np.random.default_rng(8), 2, cfg["points"]))
    loss = make_train_step(spec, opt)(raw, raw)[0]
    ref_losses, ref_grads, _, ref_stats = R.train_steps(cfg, w, [raw])
    assert float(loss) == pytest.approx(ref_losses[0], rel=1e-5)
    med = float(np.median([float(g.norm()) for g in ref_grads.values()]))
    for k, p in spec.model.named_parameters():
        g = opt.state[p]["exp_avg"] / 0.1
        assert float((g - ref_grads[k]).norm()) <= 1e-3 * max(float(ref_grads[k].norm()), med), k
    # the first step's batch statistics, read back from the running ones
    buffers = dict(spec.model.named_buffers())
    assert set(ref_stats) == {k for k in buffers if R.is_statistic(k)}
    for k, want in ref_stats.items():
        got = (buffers[k] - R.MOMENTUM * w[k]) / (1 - R.MOMENTUM)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_sensor_and_sampling():
    from pointcloud_tpu_torch.ops.ball_group import ball_group_reference
    from pointcloud_tpu_torch.ops.fps import fps_reference
    from pointcloud_tpu_torch.transforms import sensor_chain

    cfg = core.load_json("configs", "ae_pointnet2_chamfer")
    cloud = torch.from_numpy(scene.render(np.random.default_rng(9), 1, 8192)[0])
    cloud[:100, 2] = 3.0  # points above the bbox: the filter drops them
    got, _ = sensor_chain(cfg["bbox"], 2048, "FPS", 0, "cpu")(cloud)
    assert torch.equal(got, R.sense(cloud, cfg["bbox"], 2048))
    xyz = R.normalize(cloud[None, :2048], cfg["bbox"])[..., :3].contiguous()
    idx = R.fps(xyz, 512)
    assert torch.equal(idx, fps_reference(xyz, 512).long())
    centres = R.gather(xyz, idx)
    gidx, valid = R.ball_query(xyz, centres, 0.2, 32)
    _, pidx, pvalid = ball_group_reference(xyz, None, centres, None, 32, 0.2)
    assert torch.equal(gidx, pidx.long()) and torch.equal(valid, pvalid)


def test_render_is_seeded():
    a = scene.render(np.random.default_rng(3), 2, 2048)
    b = scene.render(np.random.default_rng(3), 2, 2048)
    c = scene.render(np.random.default_rng(4), 2, 2048)
    assert a.shape == (2, 2048, 6) and np.array_equal(a, b) and not np.array_equal(a, c)
    bb = np.asarray(scene.BBOX, dtype=np.float32)
    assert ((a[..., :3] >= bb[:, 0]) & (a[..., :3] <= bb[:, 1])).all()
