"""The kernel wrappers' launch counts, as a captured program keeps them.

Each wrapper counts a launch where it launches it: ``fn.launches``, and
by instance in a dict attribute of ``fn`` (``launches_by_instance`` for
the INT8 wrappers, ``instance_launches`` for flash).  A CUDA graph's
capture records launches without running them, so a captured program
takes its capture's counts back and adds them at each replay: the counts
keep saying how many launches ran.  ``counted`` is a sequence of
(wrapper, name of its by-instance dict) pairs.
"""

from __future__ import annotations


def snapshot(counted) -> tuple:
    """(launches, launches by instance) of each wrapper in ``counted``."""
    return tuple((fn.launches, dict(getattr(fn, by))) for fn, by in counted)


def delta(after: tuple, before: tuple) -> tuple:
    """What ran between two snapshots."""
    return tuple((a - b, {k: n - bi.get(k, 0) for k, n in ai.items()})
                 for (a, ai), (b, bi) in zip(after, before))


def add(counted, d: tuple, sign: int) -> None:
    """Add ``sign`` times a delta back to the wrappers' counts."""
    for (fn, by), (n, per) in zip(counted, d):
        fn.launches += sign * n
        inst = getattr(fn, by)
        for k, v in per.items():
            inst[k] += sign * v
