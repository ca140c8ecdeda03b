"""ctypes bindings for the native C++ npz batch loader (native/pcloader.cpp).

`NativeBatchLoader` reads the npz files of the cloud -> cloud autoencoder
path (fixed per-key shapes, float-convertible dtypes) in a C++ thread pool
with no Python in the hot loop, and `NativeCloudPairLoader` is a drop-in for
data.dataset.BatchLoader over a PointCloudDataset with no host transforms.
The bindings are pointcloud_tpu/data/native_loader.py's, with the same ctypes
signatures; only the library's build differs.

The library is compiled on first use from native/pcloader.cpp with
native/Makefile's flags into build/ at the root of the checkout, under a
name that carries a hash of the source and the flags, as ops/_build.py does
for the kernels:

    g++ -O3 -std=c++17 -fPIC -Wall -Wextra -pthread -shared
        -o build/libpcloader-<hash>.so native/pcloader.cpp -lz

Nothing is written under native/, and a library found there is not loaded.
A build or load that fails raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from pointcloud_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "pcloader.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libpcloader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile native/pcloader.cpp into build/ unless its library is there;
    returns the library's path, raises with the compiler's output on
    failure."""
    out = library_path()
    if out.is_file():
        return out
    if not SOURCE.is_file():
        raise RuntimeError(f"native loader source {SOURCE} is missing")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp), str(SOURCE), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native loader build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half
    return out


def get_library():
    """The native library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.pcl_create.restype = ctypes.c_void_p
        lib.pcl_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.pcl_num_batches.restype = ctypes.c_int
        lib.pcl_num_batches.argtypes = [ctypes.c_void_p]
        lib.pcl_start_epoch.argtypes = [ctypes.c_void_p]
        lib.pcl_next.restype = ctypes.c_int
        lib.pcl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.pcl_destroy.argtypes = [ctypes.c_void_p]
        lib.pcl_load_key.restype = ctypes.c_int
        lib.pcl_load_key.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def load_key(path: str, key: str, capacity: int = 1 << 24) -> np.ndarray:
    """Decode one npz key to a flat float32 array (test/diagnostic helper)."""
    lib = get_library()
    out = np.empty(capacity, np.float32)
    size = ctypes.c_int64()
    rc = lib.pcl_load_key(
        path.encode(),
        key.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity,
        ctypes.byref(size),
    )
    if rc != 0:
        raise IOError(f"pcl_load_key({path}, {key}) failed with rc={rc}")
    return out[: size.value].copy()


class NativeBatchLoader:
    """Threaded native batch iterator over npz files.

    Yields {key: (B, *shape) float32 array} dicts per batch. Per-key shapes
    are probed from the first file and must be constant across the dataset
    (the generate_pc contract guarantees this).
    """

    def __init__(
        self,
        root_dir: str,
        keys: Sequence[str] = ("points", "rgb"),
        batch_size: int = 25,
        shuffle: bool = True,
        seed: int = 0,
        threads: int = 6,
        prefetch: int = 2,
        drop_last: bool = True,
        files: Sequence[str] | None = None,
    ):
        lib = get_library()
        self.lib = lib
        names = files if files is not None else sorted(os.listdir(root_dir))
        self.files = [
            os.path.join(root_dir, f) for f in names if f.endswith(".npz")
        ]
        if not self.files:
            raise ValueError(f"no npz files in {root_dir}")
        self.keys = list(keys)
        self.batch_size = batch_size
        self.drop_last = drop_last

        probe = np.load(self.files[0])
        self.shapes = {k: probe[k].shape for k in self.keys}
        key_sizes = np.array(
            [int(np.prod(self.shapes[k])) for k in self.keys], np.int64
        )

        paths_arr = (ctypes.c_char_p * len(self.files))(
            *[p.encode() for p in self.files]
        )
        keys_arr = (ctypes.c_char_p * len(self.keys))(
            *[k.encode() for k in self.keys]
        )
        self._handle = lib.pcl_create(
            paths_arr,
            len(self.files),
            keys_arr,
            len(self.keys),
            key_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            batch_size,
            threads,
            prefetch,
            int(shuffle),
            seed,
            int(drop_last),
        )
        # keep the ctypes arrays alive for the handle's lifetime
        self._keepalive = (paths_arr, keys_arr, key_sizes)

    def __len__(self):
        return self.lib.pcl_num_batches(self._handle)

    def __iter__(self):
        self.lib.pcl_start_epoch(self._handle)
        n_total = len(self.files)
        n_batches = len(self)
        for b in range(n_batches):
            n_in = min(self.batch_size, n_total - b * self.batch_size)
            bufs = {
                k: np.empty((n_in, *self.shapes[k]), np.float32)
                for k in self.keys
            }
            ptrs = (ctypes.c_void_p * len(self.keys))(
                *[bufs[k].ctypes.data for k in self.keys]
            )
            rc = self.lib.pcl_next(self._handle, ptrs)
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"native loader failed (rc={rc}) at batch {b}")
            yield bufs

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self.lib.pcl_destroy(handle)
            self._handle = None


class NativeCloudPairLoader:
    """(in_pc, out_pc) batches via the native loader — a drop-in for
    BatchLoader over PointCloudDataset when no host-side transforms are
    configured (the default: the train step applies the transforms)."""

    def __init__(
        self,
        root_dir: str,
        in_features: Sequence[str] = ("rgb",),
        out_features: Sequence[str] = ("rgb",),
        batch_size: int = 25,
        shuffle: bool = True,
        seed: int = 0,
        threads: int = 6,
        prefetch: int = 2,
        drop_last: bool = True,
    ):
        keys = ["points"] + sorted(set(list(in_features) + list(out_features)))
        self.in_features = list(in_features)
        self.out_features = list(out_features)
        self._loader = NativeBatchLoader(
            root_dir,
            keys=keys,
            batch_size=batch_size,
            shuffle=shuffle,
            seed=seed,
            threads=threads,
            prefetch=prefetch,
            drop_last=drop_last,
        )

    def __len__(self):
        return len(self._loader)

    @staticmethod
    def _assemble(batch, features):
        cols = [batch["points"]]
        for f in features:
            arr = batch[f]
            if arr.ndim == 2:
                arr = arr[..., None]
            cols.append(arr)
        return np.concatenate(cols, axis=-1)

    def __iter__(self):
        for batch in self._loader:
            x = self._assemble(batch, self.in_features)
            y = (
                x
                if self.in_features == self.out_features
                else self._assemble(batch, self.out_features)
            )
            yield x, y
