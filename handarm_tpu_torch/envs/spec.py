"""Declarative observable/actionable MDP specification (a copy of
handarm_tpu/envs/spec.py, framework-free).

The obs/action space is a list of names in config: an Observable is a
function of an ObsContext, an Actionable a transition of the env's control
state. Dependencies are ordered by a DFS toposort.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Observable:
    """A named observation term.

    fn(ctx) -> [B, size] array. `key` routes the result: "obs" terms are
    concatenated into the flat observation vector (in active-list order);
    other keys (e.g. "pointcloud") land in the obs dict under that key
    (reference observable_vec_task.py:183-203).
    """

    name: str
    size: int
    fn: Callable[[Any], Any]
    key: str = "obs"
    requires: tuple[str, ...] = ()


@dataclass(frozen=True)
class Actionable:
    """A named action block of `size` dims in [-1, 1].

    apply(ctx, control_state, action_slice) -> new control_state.
    """

    name: str
    size: int
    apply: Callable[[Any, Any, Any], Any]


class Registry:
    def __init__(self):
        self.observables: dict[str, Observable] = {}
        self.actionables: dict[str, Actionable] = {}

    def observable(self, name, size, key="obs", requires=()):
        def deco(fn):
            self.observables[name] = Observable(name, size, fn, key, tuple(requires))
            return fn

        return deco

    def actionable(self, name, size):
        def deco(fn):
            self.actionables[name] = Actionable(name, size, fn)
            return fn

        return deco

    def resolve_observables(self, names: list[str]) -> list[Observable]:
        """Active set incl. transitive `requires`, topologically sorted with
        the requested relative order preserved for independent terms."""
        order: list[str] = []
        visiting: set[str] = set()

        def visit(n: str):
            if n in order:
                return
            if n in visiting:
                raise ValueError(f"observable dependency cycle at {n}")
            if n not in self.observables:
                raise KeyError(
                    f"unknown observable '{n}'; known: {sorted(self.observables)}"
                )
            visiting.add(n)
            for dep in self.observables[n].requires:
                visit(dep)
            visiting.remove(n)
            order.append(n)

        for n in names:
            visit(n)
        return [self.observables[n] for n in order]

    def resolve_actionables(self, names: list[str]) -> list[Actionable]:
        out = []
        for n in names:
            if n not in self.actionables:
                raise KeyError(
                    f"unknown actionable '{n}'; known: {sorted(self.actionables)}"
                )
            out.append(self.actionables[n])
        return out


def obs_layout(observables: list[Observable], requested: list[str]):
    """Start/end slices of each requested 'obs'-routed term in the flat obs
    vector (concatenated in requested-list order), mirroring the reference's
    per-observable slice bookkeeping (observable_vec_task.py:110-121)."""
    slices: dict[str, tuple[int, int]] = {}
    offset = 0
    by_name = {o.name: o for o in observables}
    for name in requested:
        o = by_name[name]
        if o.key != "obs":
            continue
        slices[name] = (offset, offset + o.size)
        offset += o.size
    return slices, offset
