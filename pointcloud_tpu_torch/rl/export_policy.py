"""Extract a deployable policy from a training artifact (a copy of
pointcloud_tpu/rl/export_policy.py; reference: rl/export_policy.py:11-26
pulls policy.pth out of a TQC zip).

Ours additionally handles the TQC pickle (already deployable — copied
through) and sb3 zips when sb3_contrib is available.
"""

from __future__ import annotations

import argparse
import os
import shutil


def export_policy(src: str, dst: str | None = None) -> str:
    dst = dst or os.path.join(os.path.dirname(src) or ".", "policy.pkl")
    if src.endswith(".pkl"):
        shutil.copyfile(src, dst)
        return dst
    if src.endswith(".zip"):
        import torch
        from sb3_contrib import TQC

        model = TQC.load(src)
        out = dst if dst.endswith(".pth") else dst.replace(".pkl", ".pth")
        torch.save(model.policy, out)
        return out
    raise ValueError(f"unknown artifact format: {src}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("--dst", default=None)
    a = p.parse_args()
    print(export_policy(a.src, a.dst))
