"""The CoPRIS trajectory buffer (paper eq. 7).

    B = { (tau_i, L_i) | i in I_active }

Holds, across training stages:
* **unfinished** trajectories cut off by early termination — resumed with
  priority at the next rollout stage, their new tokens appended under the new
  policy version (so L_i becomes a cross-stage concatenation);
* **finished** trajectories whose group has not completed yet — they wait in
  the buffer unchanged until their group closes, then train with IS
  correction.

The buffer orders resumable work longest-first (prioritized resumption —
longest partials are the long-tail stragglers; restarting them first
minimises their expected finish stage).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.trajectory import Group, Trajectory


class TrajectoryBuffer:
    def __init__(self):
        self._groups: Dict[int, Group] = {}

    # ------------------------------------------------------------------
    def add_group(self, group: Group):
        self._groups[group.group_id] = group

    def groups(self) -> List[Group]:
        return list(self._groups.values())

    def __len__(self):
        return sum(len(g.trajectories) for g in self._groups.values())

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    @property
    def num_unfinished(self) -> int:
        return sum(1 for g in self._groups.values()
                   for t in g.trajectories if not t.done)

    # ------------------------------------------------------------------
    def pop_resumable(self, exclude=()) -> Optional[Trajectory]:
        """Longest unfinished partial trajectory (prioritized resumption).
        ``exclude``: traj_ids currently in flight. Trajectories parked on a
        pending environment step own no decodable state — they re-enter
        dispatch only once their observation lands (awaiting_env clears)."""
        best = None
        for g in self._groups.values():
            for t in g.trajectories:
                if (not t.done and not t.awaiting_env
                        and t.traj_id not in exclude
                        and (best is None or t.total_len > best.total_len)):
                    best = t
        if best is not None:
            best.resume_count += 1
        return best

    def pop_unspawned(self) -> Optional[Trajectory]:
        """A group that still needs more samples spawns a fresh trajectory
        (buffered groups must reach G samples before they can complete)."""
        for g in self._groups.values():
            if len(g.trajectories) < g.size:
                return g.spawn()
        return None

    def pop_complete_groups(self) -> List[Group]:
        """Remove and return all groups whose G trajectories are all done."""
        done_ids = [gid for gid, g in self._groups.items() if g.complete]
        out = [self._groups.pop(gid) for gid in done_ids]
        for g in out:
            for t in g.trajectories:
                t.check_invariants()
        return out
