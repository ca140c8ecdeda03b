"""The program's own spans and counts (the recorder of
pointcloud_tpu_torch.utils.profiling), as the per-layer metrics read them.

The program records its per-step spans only while a torch.profiler session
is open, so nothing is recorded in warm-up; the traced window's requests
are the first roots of their kind, and the labelling window that follows
it is left out by taking only the first `n` (the window's observations or
steps). The set-up spans record always and are summed whole. Every reader
returns None where the program recorded nothing (a program without the
recorder, or a run on the CPU).
"""

from __future__ import annotations


def recorded() -> list:
    """The program's closed spans in the order they opened ([] where the
    program has no recorder)."""
    try:
        from pointcloud_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return read() if callable(read) else []


def requests(root: str, n: int):
    """(roots, spans) for the first n roots named `root`: the roots and
    every span under them (roots included). None where there is none."""
    spans = recorded()
    roots = [s for s in spans if s.parent is None and s.name == root][:n]
    if not roots:
        return None
    ids = {s.id for s in roots}
    return roots, [s for s in spans if s.root in ids]


def mean_host_ms(root: str, n: int, names) -> float | None:
    """The mean over the first n roots of the host ms of their spans named
    in `names`, summed."""
    got = requests(root, n)
    if got is None:
        return None
    roots, spans = got
    return 1e3 * sum(s.seconds for s in spans if s.name in names) / len(roots)


def mean_device_ms(root: str, n: int, prefix: str) -> float | None:
    """The mean over the first n roots of the device ms (CUDA event pairs)
    of their spans whose name starts with `prefix`, summed; None where they
    recorded no events."""
    got = requests(root, n)
    if got is None:
        return None
    roots, spans = got
    times = [s.device_ms() for s in spans if s.name.startswith(prefix)]
    times = [t for t in times if t is not None]
    return sum(times) / len(roots) if times else None


def mean_count(roots, n: int, name: str) -> float | None:
    """The count `name` summed over every span under the first n roots of
    each name in `roots`, over n."""
    total, found = 0, 0
    for root in roots:
        got = requests(root, n)
        if got is None:
            continue
        found = max(found, len(got[0]))
        total += sum(s.counts.get(name, 0) for s in got[1])
    return total / found if found else None


def setup_seconds(name: str) -> float | None:
    """The seconds of every span named `name`, summed."""
    spans = [s for s in recorded() if s.name == name]
    return sum(s.seconds for s in spans) if spans else None
