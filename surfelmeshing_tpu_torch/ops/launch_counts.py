"""The launch counters of the port's hand-written kernels, in one place.

Each wrapper that launches a kernel counts it in an attribute of its own
function (blend.blend_core.launches, preprocess.erode_depth.launches,
gather.gather_rows.launches, ...) and registers that attribute here
under a name of its own.  Code that has to move every counter at once
works on the registry and need not know which modules feed it:

- a CUDA graph's capture runs the wrappers on the host without launching
  anything, so chunk.py takes a `snapshot` before it, keeps what the
  capture added (`since`) as the graph's own counts, `restore`s the
  snapshot, and `add`s the graph's counts at each replay;
- a measurement that counts one run's launches `zero`es them first.
"""

from __future__ import annotations

# name -> (function, attribute)
_COUNTERS: dict = {}


def register(name: str, fn, attr: str = "launches") -> None:
    """Count `name` in `fn.<attr>`, starting at 0."""
    if name in _COUNTERS:
        raise ValueError(f"launch counter {name!r} registered twice")
    setattr(fn, attr, 0)
    _COUNTERS[name] = (fn, attr)


def snapshot() -> dict:
    """Every counter's value, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in
            _COUNTERS.items()}


def since(before: dict) -> dict:
    """What each counter added after `before` (a snapshot), by name."""
    return {name: value - before.get(name, 0)
            for name, value in snapshot().items()}


def restore(counts: dict) -> None:
    """Set the named counters to `counts`' values."""
    for name, value in counts.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, value)


def add(counts: dict) -> None:
    """Add `counts`' values to the named counters."""
    now = snapshot()
    restore({name: now[name] + value for name, value in counts.items()})


def zero() -> None:
    """Set every counter to 0."""
    restore(dict.fromkeys(_COUNTERS, 0))
