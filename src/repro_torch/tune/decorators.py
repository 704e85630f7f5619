"""``@autotune`` — resolve tuning parameters at call time from the cache
(the port's copy of ``repro.tune.decorators``).

Wrap a kernel entry point whose tuning parameters default to ``None``;
on each call with one of them omitted, the decorator builds the kernel's
Tunable from the actual arguments (shapes, dtype, flags), tunes through
:func:`repro_torch.tune.tune` (served from the persistent cache on a hit), and
injects the tuned values:

    @autotune(lambda a, b, **kw: MatmulTunable(M=a.shape[0], ...),
              params=("bm", "bn", "bk"))
    def matmul_tuned(a, b, *, bm=None, bn=None, bk=None): ...

Explicitly passed parameters always win: with *all* of them given no
tuning runs at all, and with a subset given the remainder is tuned with
the explicit values pinned into the lattice — the joint constraints of
the space (e.g. shared-memory residency) still apply to the combined
configuration.  Resolved configs are additionally memoized in-process
(keyed by the Tunable, when hashable) so hot call sites skip the
fingerprint/hash/cache machinery after the first call.  The wrapped
function also exposes ``fn.tune(*args, **kw) -> TuneResult`` to inspect
the decision the decorator would make for those arguments.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, Sequence

from ..core.search_space import Param, SearchSpace
from .api import tune as _tune
from .cache import tunable_fingerprint


class _PinnedTunable:
    """Restrict a tunable's lattice to configurations matching the
    caller's explicitly passed parameters (constraints preserved)."""

    def __init__(self, inner, pinned: Mapping[str, Any]):
        self.inner = inner
        self.pinned = dict(pinned)
        self.name = getattr(inner, "name", type(inner).__name__)

    def space(self) -> SearchSpace:
        s = self.inner.space()
        return SearchSpace(
            params=[Param(p.name, (self.pinned[p.name],))
                    if p.name in self.pinned else p for p in s.params],
            constraints=list(s.constraints))

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return self.inner.cost(cfg)

    def fingerprint(self) -> dict[str, Any]:
        return {**tunable_fingerprint(self.inner),
                "pinned": dict(sorted(self.pinned.items()))}


def autotune(make_tunable: Callable[..., Any], *, params: Sequence[str],
             engine: str = "grid", cache="default", **tune_kw: Any):
    """``make_tunable(*args, **kw)`` receives the call's arguments with
    the tuning ``params`` stripped and returns the Tunable to search."""

    params = tuple(params)

    def deco(fn):
        memo: dict[Any, dict[str, Any]] = {}

        def resolve(args, kw):
            call_kw = {k: v for k, v in kw.items() if k not in params}
            tunable = make_tunable(*args, **call_kw)
            pinned = {p: kw[p] for p in params if kw.get(p) is not None}
            memo_key = None
            try:
                memo_key = (tunable, tuple(sorted(pinned.items())))
                best = memo.get(memo_key)
                if best is not None:
                    return best
            except TypeError:
                memo_key = None           # unhashable tunable: no memo
            target = _PinnedTunable(tunable, pinned) if pinned else tunable
            res = _tune(target, engine=engine, cache=cache, **tune_kw)
            if memo_key is not None:
                memo[memo_key] = res.best_config
            return res.best_config

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            missing = [p for p in params if kw.get(p) is None]
            if missing:
                best = resolve(args, kw)
                for p in missing:
                    kw[p] = best[p]
            return fn(*args, **kw)

        def tune_for(*args, **kw):
            call_kw = {k: v for k, v in kw.items() if k not in params}
            pinned = {p: kw[p] for p in params if kw.get(p) is not None}
            tunable = make_tunable(*args, **call_kw)
            target = _PinnedTunable(tunable, pinned) if pinned else tunable
            return _tune(target, engine=engine, cache=cache, **tune_kw)

        wrapper.tune = tune_for
        wrapper.tuned_params = params
        return wrapper
    return deco


__all__ = ["autotune"]
