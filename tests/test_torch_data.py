"""The port's data pipeline against the JAX package's, on npz frames the JAX
package's generator writes (tests/test_train.py's fixture: 128 points, 16
train and 4 val frames): the datasets' items exactly equal, `BatchLoader`'s
batches and their order exactly equal for seeds 0 and 1, shuffled or not,
with or without the last partial batch, and the native loader, built from
native/pcloader.cpp into build/, batch for batch equal to the JAX package's
`NativeCloudPairLoader` over two epochs. Also the copied dataset module
against its original, `apply_np`, the training settings of `cfg`, the native
loader's build rule (a library that does not build raises, and so does
train() that needs it), and the profiling helpers."""

import ast
import inspect
import os

import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)

import pointcloud_tpu.cfg as jcfg
import pointcloud_tpu.data.dataset as jdataset
from pointcloud_tpu.data import native_loader as jnative
from pointcloud_tpu.envs.synthetic import generate_dataset
from pointcloud_tpu.transforms import Normalize as JNormalize
from pointcloud_tpu.transforms import apply_np as japply_np
from pointcloud_tpu_torch import cfg as tcfg
from pointcloud_tpu_torch.data import dataset as tdataset
from pointcloud_tpu_torch.data import native_loader as tnative
from pointcloud_tpu_torch.transforms import Normalize, apply_np

N_PTS = 128


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """input/<scene>/{train,val} layout with tiny clouds."""
    root = tmp_path_factory.mktemp("input_root")
    d = root / "Cube"
    generate_dataset(str(d / "train"), scene="Cube", frames=16, seed=0, sample_points=N_PTS)
    generate_dataset(str(d / "val"), scene="Cube", frames=4, seed=99, sample_points=N_PTS)
    return str(root)


def split(data_root, name):
    return os.path.join(data_root, "Cube", name)


def assert_same(a, b):
    """Two items or batches (arrays, tuples or dicts of them) exactly equal,
    dtypes included."""
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("out_features", [["rgb"], ["segmentation"], ["rgb", "segmentation"]])
def test_cloud_dataset_items_equal_the_jax_packages(data_root, out_features):
    kw = dict(in_features=["rgb"], out_features=out_features)
    j = jdataset.PointCloudDataset(split(data_root, "train"), **kw)
    t = tdataset.PointCloudDataset(split(data_root, "train"), **kw)
    assert len(t) == len(j) == 16 and t.files == j.files
    for i in range(len(j)):
        assert t.filename(i) == j.filename(i)
        assert_same(t[i], j[i])


def test_gt_dataset_items_equal_the_jax_packages(data_root):
    j = jdataset.PointCloudGTDataset(split(data_root, "val"), in_features=["rgb"])
    t = tdataset.PointCloudGTDataset(split(data_root, "val"), in_features=["rgb"])
    assert len(t) == len(j) == 4
    for i in range(len(j)):
        assert_same(t[i], j[i])
    swapped = tdataset.PointCloudGTDataset(split(data_root, "val"), swap_xy=True)
    assert_same(swapped[0], j[0][::-1])


def test_host_transforms_equal_the_jax_packages(data_root):
    """A dataset with host-side transforms runs them through apply_np."""
    bbox = [[-0.5, 0.5], [-0.5, 0.5], [0.7, 1.5]]
    j = jdataset.PointCloudDataset(split(data_root, "val"), in_transform=JNormalize(bbox),
                                   out_transform=JNormalize(bbox))
    t = tdataset.PointCloudDataset(split(data_root, "val"), in_transform=Normalize(bbox),
                                   out_transform=Normalize(bbox))
    for i in range(len(j)):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_loader_equals_the_jax_packages(data_root, seed, shuffle, drop_last):
    """Same batches in the same order: 16 frames in batches of 5 (three
    whole batches and a partial one), two epochs of one loader (the shuffle
    draws again each epoch)."""
    kw = dict(batch_size=5, shuffle=shuffle, seed=seed, threads=3, prefetch=2,
              drop_last=drop_last)
    ds = dict(in_features=["rgb"], out_features=["segmentation"])
    j = jdataset.BatchLoader(jdataset.PointCloudDataset(split(data_root, "train"), **ds), **kw)
    t = tdataset.BatchLoader(tdataset.PointCloudDataset(split(data_root, "train"), **ds), **kw)
    assert len(t) == len(j) == (3 if drop_last else 4)
    for _ in range(2):
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) == len(j)
        for a, b in zip(tb, jb):
            assert_same(a, b)
    assert tb[-1][0].shape[0] == (5 if drop_last else 1)


def test_gt_batches_stack_dicts(data_root):
    t = tdataset.BatchLoader(tdataset.PointCloudGTDataset(split(data_root, "train")),
                             batch_size=4, seed=3)
    j = jdataset.BatchLoader(jdataset.PointCloudGTDataset(split(data_root, "train")),
                             batch_size=4, seed=3)
    for a, b in zip(t, j):
        assert isinstance(a[1], dict)
        assert_same(a, b)


@pytest.mark.parametrize("shuffle,drop_last,features", [
    (True, True, ["rgb"]), (False, False, ["rgb"]), (True, False, ["segmentation"])])
def test_native_loader_equals_the_jax_packages(data_root, shuffle, drop_last, features):
    """The port's native loader against the JAX package's over two epochs:
    equal batches in equal order."""
    kw = dict(in_features=["rgb"], out_features=features, batch_size=5,
              shuffle=shuffle, seed=1, threads=3, prefetch=2, drop_last=drop_last)
    j = jnative.NativeCloudPairLoader(split(data_root, "train"), **kw)
    t = tnative.NativeCloudPairLoader(split(data_root, "train"), **kw)
    assert len(t) == len(j) == (3 if drop_last else 4)
    for _ in range(2):
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) == len(j)
        for a, b in zip(tb, jb):
            assert_same(a, b)


def test_native_loader_matches_the_python_loader_unshuffled(data_root):
    """Unshuffled, the native batches are the Python loader's."""
    ds = tdataset.PointCloudDataset(split(data_root, "train"))
    py = list(tdataset.BatchLoader(ds, 5, shuffle=False, drop_last=False))
    nat = list(tnative.NativeCloudPairLoader(split(data_root, "train"), batch_size=5,
                                             shuffle=False, drop_last=False))
    assert len(py) == len(nat) == 4
    for a, b in zip(nat, py):
        assert_same(a, b)


def test_native_library_is_built_into_build(data_root):
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.parent.name == "build"
    assert path.name.startswith("libpcloader-") and path.suffix == ".so"
    assert tnative.build() == path and path.is_file()
    assert tnative.SOURCE.parent.name == "native"
    name = sorted(os.listdir(split(data_root, "val")))[0]
    f = os.path.join(split(data_root, "val"), name)
    ref = np.load(f)
    for key in ("points", "rgb", "segmentation"):
        np.testing.assert_array_equal(tnative.load_key(f, key),
                                      np.asarray(ref[key], np.float32).reshape(-1))


@pytest.fixture
def broken_compiler(monkeypatch):
    """A compiler that fails, and flags whose hash names no library yet."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(tnative, "CXXFLAGS", tnative.CXXFLAGS + ("-DPCL_UNBUILT",))
    monkeypatch.setattr(tnative, "_lib", None)
    assert not tnative.library_path().is_file()


def test_native_library_that_does_not_build_raises(broken_compiler, data_root):
    with pytest.raises(RuntimeError, match="native loader build failed"):
        tnative.get_library()
    with pytest.raises(RuntimeError, match="native loader build failed"):
        tnative.NativeCloudPairLoader(split(data_root, "train"))


def test_train_raises_where_the_native_library_does_not_build(broken_compiler, data_root,
                                                              tmp_path, monkeypatch):
    """No fallback to the threaded loader: cfg.use_native_loader = False is
    the way to choose it."""
    from pointcloud_tpu_torch.train import train

    assert tcfg.use_native_loader
    with pytest.raises(RuntimeError, match="native loader build failed"):
        train("Autoencoder", "PointNet", "Cube", epochs=1, batch_size=4,
              input_root=data_root, output_root=str(tmp_path), device="cpu")


def strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:]
    return tree


def test_dataset_module_is_a_copy_of_the_jax_packages():
    """The copy's code is the original's, docstrings aside and with
    apply_np taken from the port."""
    port = inspect.getsource(tdataset).replace("pointcloud_tpu_torch.", "pointcloud_tpu.")
    assert ast.dump(strip_docstrings(ast.parse(port))) == ast.dump(
        strip_docstrings(ast.parse(inspect.getsource(jdataset))))


def test_apply_np_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    pc = rng.random((64, 6), dtype=np.float32)
    mask = rng.random(64) > 0.3
    bbox = [[-0.5, 0.5], [-0.5, 0.5], [0.7, 1.5]]
    for m in (None, mask):
        got = apply_np(Normalize(bbox), pc, m, seed=3)
        want = japply_np(JNormalize(bbox), pc, m, seed=3)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[1], want[1])
        assert isinstance(got[0], np.ndarray) and got[1].dtype == np.bool_


def test_apply_np_seeds_and_restores_the_generator():
    def noisy(pc, mask):
        return pc + torch.rand(pc.shape), torch.ones(pc.shape[:-1], dtype=torch.bool)

    pc = np.zeros((8, 3), np.float32)
    state = torch.random.get_rng_state()
    a = apply_np(noisy, pc, seed=7)[0]
    assert torch.equal(torch.random.get_rng_state(), state)
    np.testing.assert_array_equal(a, apply_np(noisy, pc, seed=7)[0])
    assert not np.array_equal(a, apply_np(noisy, pc, seed=8)[0])


def test_training_settings_are_the_jax_packages():
    for name in ("models", "encoder_backbones", "vision_batch_size", "vision_epochs",
                 "vision_lr", "val_every", "ckpt_every", "prefetch_batches",
                 "loader_threads", "use_native_loader"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert vars(tcfg.TrainConfig()) == vars(jcfg.TrainConfig())
    assert vars(tcfg.TrainConfig.from_globals()) == vars(jcfg.TrainConfig.from_globals())


def test_step_timer_and_trace(tmp_path):
    """trace() writes trace.json, and it holds the program's spans: an eval
    step's root, its phases and its SA levels, as user annotations."""
    import json

    from pointcloud_tpu_torch.train.harness import create_model, make_eval_step
    from pointcloud_tpu_torch.utils import profiling
    from pointcloud_tpu_torch.utils.profiling import trace

    spec = create_model("Autoencoder", "PointNet2", "Cube", loss_override="chamfer",
                        device="cpu")
    step = make_eval_step(spec)
    x = torch.rand(1, 1024, 6)
    profiling.reset()
    try:
        with trace(str(tmp_path / "profile")):
            step(x, x)
        names = [s.name for s in profiling.spans()]
    finally:
        profiling.reset()
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    traced = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert names[0] == "step.eval" and set(names) == traced == {
        "step.eval", "step.transforms", "step.forward", "step.loss",
        "encoder.SetAbstraction_0", "encoder.SetAbstraction_1", "encoder.SetAbstraction_2"}
