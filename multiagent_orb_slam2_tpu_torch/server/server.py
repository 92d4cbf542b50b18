"""MultiAgentServer: the central fusion service coordinating N agents.

Counterpart of the JAX package's ``server/server.py`` (reference
MultiAgentServer and the MapFusion thread loop). It owns the global keyframe
database and the MultiMap registry, and one Tracker and one LoopCloser per
agent, all on one SharedMap. Every keyframe that closes no loop inside its
own map goes to fusion: cross-map candidate detection, Sim3 verification,
FuseMaps, covisibility discovery and a global BA.

Host waits on the fusion path: one read of the candidate mask with the map
labels per keyframe query, one of the candidates' covisibility rows when
there are candidates, one stacked read of the map labels and sizes at a
fusion, then those of ``fusion.merge_maps`` and
``fusion.covisibility_discovery``, and one synchronize at the end of each
timed stage of a fusion.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SlamConfig
from ..mapstate import state as ms
from ..runtime import loop_closing as lc
from ..runtime import reloc as reloc_mod
from ..runtime.tracker import SharedMap, Tracker, TrackerState
from ..utils import diag
from ..utils.torch_ops import host_fetch
from ..vocab import bow as bow_mod
from ..vocab import kfdb as kfdb_mod
from . import fusion
from .multimap import MultiMap


class MultiAgentServer:
    def __init__(self, cfg: SlamConfig, vocab: bow_mod.Vocabulary,
                 run_gba: bool = True, device=torch.device("cuda")):
        self.cfg = cfg
        self.vocab = vocab
        self.device = torch.device(device)
        self.shared = SharedMap(cfg, device=self.device)
        self.multimap = MultiMap()
        self.db = kfdb_mod.empty_database(cfg.caps.max_keyframes, vocab)
        self.consistency: dict[int, list] = {}   # per-agent groups
        self.run_gba = run_gba
        self.trackers: dict[int, Tracker] = {}
        self.loop_closers: dict[int, lc.LoopCloser] = {}
        self.stats: list[dict] = []              # MAP_FUSION_STATS
        self.n_relocalizations = 0

    # -- registration (RegisterClient) --------------------------------------

    def register_client(self, agent: int) -> Tracker:
        map_id = agent  # each agent starts on its own logical map
        tracker = Tracker(self.cfg, self.shared, agent=agent, map_id=map_id,
                          device=self.device)
        self.trackers[agent] = tracker
        self.loop_closers[agent] = lc.LoopCloser(self.cfg, self.vocab)
        self.multimap.add(agent, map_id)
        self.consistency[agent] = []
        tracker.on_reset = self._handle_reset
        return tracker

    def _handle_reset(self, tracker: Tracker):
        """A reset agent restarts on a fresh logical map: its new keyframes
        begin at an identity origin unrelated to the old map's world frame,
        so they must re-enter through the Sim3 fusion pipeline."""
        new_id = max(self.multimap.map_of_agent.values(), default=-1) + 1
        self.multimap.add(tracker.agent, new_id)
        tracker.map_id = new_id
        self.consistency[tracker.agent] = []
        self.loop_closers[tracker.agent].consistency.groups = []

    # -- per-keyframe processing (the MapFusion::Run loop) -------------------

    def maybe_relocalize(self, agent: int) -> bool:
        """Relocalize a LOST tracker against the global database, scoped to
        its own map (relocalizing into another agent's map before a verified
        fusion would alias two world frames)."""
        tracker = self.trackers[agent]
        if tracker.state != TrackerState.LOST or tracker.last_feats is None:
            return False
        ok = reloc_mod.relocalize(tracker, self.db, self.vocab,
                                  tracker.last_feats, self.cfg,
                                  map_id=self.multimap.map_of(agent))
        if ok:
            self.n_relocalizations += 1
        return ok

    def process_new_keyframes(self):
        """Drain every tracker's queues: relocalize LOST trackers; erase
        culled keyframes from the global and the agent's database, after
        which their slots are reusable; run the agent's own loop closing on
        each new keyframe; keyframes that close no loop go to fusion."""
        for agent in self.trackers:
            self.maybe_relocalize(agent)
        for agent, tracker in self.trackers.items():
            drained = False
            while tracker.culled_kf_slots:
                k = tracker.culled_kf_slots.pop(0)
                self.db = kfdb_mod.erase_keyframe(self.db, k)
                self.loop_closers[agent].db = kfdb_mod.erase_keyframe(
                    self.loop_closers[agent].db, k)
                drained = True
            if drained:
                self.shared.reclaim_slots()
            while tracker.new_kf_slots:
                kf_slot = tracker.new_kf_slots.pop(0)
                tracker.map_id = self.multimap.map_of(agent)
                lc_match = self.loop_closers[agent].process_keyframe(
                    self.shared, kf_slot)
                if lc_match is not None:
                    self.loop_closers[agent].correct_loop(
                        self.shared, lc_match, run_gba=self.run_gba)
                    continue
                self._insert_keyframe_fusion(agent, kf_slot)

    def _insert_keyframe_fusion(self, agent: int, kf_slot: int):
        """One MapFusion iteration for a queued keyframe: the global
        database insert and the candidate query, then Sim3 verification of
        the consistent candidates; the first verified one is fused."""
        self.db, cand_mask, words, valid, vec = _fusion_detect_query(
            self.db, self.vocab, self.shared.state, kf_slot)

        if self.multimap.n_maps < 2:
            return  # everything already fused

        cands = self._detect_fusion_candidates(agent, kf_slot, cand_mask,
                                               words, valid, vec)
        closer = self.loop_closers[agent]
        for c in cands:
            t0 = time.perf_counter()
            match = closer.compute_sim3(self.shared, kf_slot, c)
            sim3_ms = (time.perf_counter() - t0) * 1e3
            if match is None:
                continue
            self._fuse(agent, match, sim3_ms)
            return

    def _detect_fusion_candidates(self, agent, kf_slot, cand_mask, words,
                                  valid, vec):
        """DetectFusionCandidates: the global query's candidates, minus
        those on the agent's own map, then the agent's covisibility
        consistency groups >= consistency_th. One read of the mask and the
        map labels, and one of the surviving candidates' covisibility
        rows."""
        st = self.shared.state
        cur_map = self.multimap.map_of(agent)
        mask, kf_map = host_fetch(torch.stack([cand_mask.to(torch.int32),
                                               st.kf_map]))
        cand_pre = np.nonzero(mask)[0].tolist()
        cand = [c for c in cand_pre if kf_map[c] != cur_map
                and kf_map[c] >= 0]
        th = self.cfg.loop.consistency_th
        new_groups, enough, counts = [], [], []
        rows = (host_fetch(torch.stack([st.covis[c] for c in cand]))
                if cand else [])
        for c, row in zip(cand, rows):
            group = set(np.nonzero(row > 0)[0].tolist()) | {c}
            best = 0
            for (g, count) in self.consistency[agent]:
                if group & g:
                    best = max(best, count + 1)
            new_groups.append((group, best))
            counts.append(best)
            if best >= th:
                enough.append(c)
        self.consistency[agent] = new_groups
        if diag.recall_sink().enabled:
            dbq = kfdb_mod.erase_keyframe(self.db, kf_slot)
            diag.log_recall_query(
                "fusion", agent, kf_slot, int(st.kf_frame_id[kf_slot]),
                dbq, words, valid, vec, None, kf_map, cur_map,
                cand_pre, enough, counts)
        return enough

    def _fuse(self, agent: int, match: lc.Sim3Match, sim3_ms: float):
        """Merge the agent's map into the matched one, run covisibility
        discovery over the moved live keyframes and (run_gba) a global BA;
        append the stats row. ckf counts the moved live keyframes, as the
        reference's column does; the JAX package's count includes culled
        slots that still carry the map's label."""
        cfg = self.cfg
        st = self.shared.state
        dev = self.device
        cur_map = self.multimap.map_of(agent)
        K = st.kf_q.shape[0]
        # pre-fusion map sizes (stats columns ckf / cmp / mkf / mmp: the
        # keyframe and point counts of the current and matched maps)
        dst = st.kf_map[match.kf_match]
        cur_mp = (st.mp_map == cur_map) & st.mp_valid
        dst_kf = (st.kf_map == dst) & st.kf_valid
        dst_mp = (st.mp_map == dst) & st.mp_valid
        host = host_fetch(torch.cat([
            st.kf_map.long(), st.kf_valid.long(),
            torch.stack([cur_mp.sum(), dst_kf.sum(), dst_mp.sum(),
                         dst.long()])]))
        kf_map, kf_valid = host[:K], host[K:2 * K].astype(bool)
        cmp_, mkf, mmp, dst_map = (int(x) for x in host[2 * K:])
        moved = np.nonzero((kf_map == cur_map) & kf_valid)[0].tolist()

        t0 = time.perf_counter()
        fusion.merge_maps(self.shared, self.multimap, match, cur_map,
                          dst_map, cfg)
        # every tracker of the merged map labels its next keyframe with it
        # (the reference's UpdateSystemMapAssociations; the JAX package
        # updates a tracker's map id only when its next keyframe is
        # drained, so that keyframe keeps the absorbed map's id)
        for a in self.multimap.agents_of(dst_map):
            self.trackers[a].map_id = dst_map
        fusion._sync(dev)
        mf_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        n_cd, cd_per_kf = fusion.covisibility_discovery(
            self.shared, self.db, self.vocab, moved, cfg)
        fusion._sync(dev)
        cd_ms = (time.perf_counter() - t0) * 1e3

        gba_ms = 0.0
        if self.run_gba:
            t0 = time.perf_counter()
            self.shared.state = lc.global_bundle_adjustment(self.shared.state,
                                                            cfg)
            fusion._sync(dev)
            gba_ms = (time.perf_counter() - t0) * 1e3

        # stats.csv schema (reference generic_split_seq.cc; the cd aggregate
        # columns of MapFusion::CovisibilityDiscovery)
        cd_arr = np.asarray(cd_per_kf) if cd_per_kf else np.zeros(1)
        self.stats.append(dict(
            sim3_ms=sim3_ms, mf_ms=mf_ms, ckf=len(moved), cmp=cmp_, mkf=mkf,
            mmp=mmp, cd_ms=cd_ms, cd_sum_ms=float(cd_arr.sum()),
            cd_mean_ms=float(cd_arr.mean()), cd_stdev_ms=float(cd_arr.std()),
            cd_med_ms=float(np.median(cd_arr)), n_cd=n_cd, gba_ms=gba_ms,
            cur_map=cur_map, dst_map=dst_map))

    # -- shutdown (Shutdown / ShutdownSystems) -------------------------------

    def shutdown(self):
        self.process_new_keyframes()


@torch.no_grad()
def _fusion_detect_query(db, vocab, st: ms.MapState, kf_slot: int):
    """Global database insert plus the fusion candidate query, no host
    read. The query has no minScore gate (the consistency groups do that
    work), unlike loop detection's ``loop_closing._detect_loop_query``."""
    valid = st.kf_feat_valid[kf_slot]
    db2, words, vec = kfdb_mod.add_keyframe(db, vocab, kf_slot,
                                            st.kf_desc[kf_slot], valid)
    dbq = kfdb_mod.erase_keyframe(db2, kf_slot)
    cand_mask, _ = kfdb_mod.detect_loop_candidates(
        dbq, vocab, words, valid, vec, st.covis[kf_slot], kf_slot,
        st.covis, None)
    return db2, cand_mask, words, valid, vec
