"""Versioned weight-sync between the train and rollout sides of the loop.

The port of ``repro.core.weight_sync.ParamStore``. The trainer
**publishes** each optimizer update as ``(params, version)``; the rollout
side **acquires** the freshest published version. The contract:

* ``publish`` is strictly version-monotonic — republishing an old version is
  a programming error (the off-policy accounting keys on version order);
* the store keeps a bounded window of in-flight versions and *drops stale*
  ones as new params land;
* ``acquire`` always returns the freshest version — rollout never waits for
  weights, staleness is bounded by the trainer's pipeline gate instead.

JAX arrays are immutable, so the reference stores references. The port's
trainer updates its parameter tensors in place (``optim/adam.update``), so
``publish`` stores **detached clones**: a published version never changes
under a rollout that holds it. The train-to-rollout reshard of the
disaggregated mode (``make_param_resharder``) is SPMD and is not ported.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Tuple

from repro_torch.common.tree import tree_map


class ParamStore:
    """Thread-safe versioned params channel (publish / acquire).

    ``max_versions`` bounds how many published versions may be in flight at
    once: with a pipeline that lets rollout lag the trainer by at most K
    optimizer updates, ``K + 1`` versions cover every batch still in the
    system; anything older is dropped at publish time (``stats["dropped"]``
    counts the drop-stale evictions).
    """

    def __init__(self, *, max_versions: int = 2):
        if max_versions < 1:
            raise ValueError(
                f"max_versions must be >= 1 (got {max_versions}); the store "
                "must be able to hold at least the freshest version")
        self._max_versions = max_versions
        self._cv = threading.Condition()
        self._versions: "OrderedDict[int, Any]" = OrderedDict()
        self.stats = dict(published=0, dropped=0, acquired=0)

    @property
    def num_versions(self) -> int:
        with self._cv:
            return len(self._versions)

    # ------------------------------------------------------------------
    def publish(self, params, version: int, *, replace: bool = False):
        """Make a detached copy of ``params`` available as ``version``.

        ``replace=True`` permits re-publishing the CURRENT latest version
        (checkpoint restore swapping the weights behind an unchanged stage
        number); versions are otherwise strictly monotonic.
        """
        snapshot = tree_map(lambda t: t.detach().clone(), params)
        with self._cv:
            latest = next(reversed(self._versions)) if self._versions else -1
            if version < latest or (version == latest and not replace):
                raise ValueError(
                    f"ParamStore.publish: version {version} <= latest "
                    f"published {latest} — versions must be strictly "
                    "monotonic (one publish per optimizer update)")
            self._versions[version] = snapshot
            self.stats["published"] += 1
            while len(self._versions) > self._max_versions:   # drop-stale
                self._versions.popitem(last=False)
                self.stats["dropped"] += 1
            self._cv.notify_all()

    def acquire(self) -> Tuple[Any, int]:
        """Freshest ``(params, version)``. Rollout never generates under a
        superseded version when a newer one has been published."""
        with self._cv:
            if not self._versions:
                raise RuntimeError(
                    "ParamStore.acquire before the first publish — the "
                    "trainer must publish its initial params (version = "
                    "start stage) at construction")
            version = next(reversed(self._versions))
            self.stats["acquired"] += 1
            return self._versions[version], version

    def stats_snapshot(self) -> dict:
        """Consistent copy of the counters."""
        with self._cv:
            return dict(self.stats)
