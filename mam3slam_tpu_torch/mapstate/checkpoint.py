"""Atlas checkpoint and resume.

Port of ``mam3slam_tpu.mapstate.checkpoint``.  The atlas is one flat
tuple of tensors, so a checkpoint is one compressed npz: every
``MapState`` field as ``ms_<field>`` in its own dtype, the agents'
tracking state (``agent_scalars`` int64 [n, 5]: id, state, map, reference
keyframe, next agent keyframe id; ``agent_has_pose``, ``agent_q``,
``agent_t``) and, with a server, its vocabulary (``srv_voc_*``, the
centroids as packed u8) and keyframe database (``srv_kf_bow_*``).  The
format is the reference's, so either package loads a file the other
wrote.
"""

from __future__ import annotations

import numpy as np
import torch

from mam3slam_tpu_torch.mapstate import state as S
from mam3slam_tpu_torch.ops import bow

# MapConfig.max_loop_edges of the reference when loop edges were added:
# the size of the loop-edge fields that old checkpoints lack, whatever the
# current configuration says
OLD_FILE_LOOP_EDGES = 64


def save_atlas(system, path: str, server=None) -> None:
    arrays = {f"ms_{name}": val.cpu().numpy()
              for name, val in zip(S.MapState._fields, system.ms)}
    n = len(system.agents)
    ag_scalars = np.zeros((n, 5), np.int64)
    ag_has_pose = np.zeros(n, bool)
    ag_q = np.zeros((n, 4), np.float32)
    ag_t = np.zeros((n, 3), np.float32)
    for i, a in enumerate(system.agents):
        ag_scalars[i] = [a.agent_id, a.state, a.map_id, a.ref_kf,
                         a.next_agent_kf_id]
        if a.q is not None:
            ag_has_pose[i] = True
            ag_q[i] = np.asarray(a.q)
            ag_t[i] = np.asarray(a.t)
    srv = {}
    if server is not None and server.voc is not None:
        voc = server.voc
        srv["voc_meta"] = np.asarray([voc.k, voc.depth])
        srv["voc_idf"] = voc.idf.cpu().numpy()
        for i, lvl in enumerate(voc.centroid_bits):
            srv[f"voc_level_{i}"] = lvl.cpu().numpy()
        if voc.leaf_map is not None:
            srv["voc_leaf_map"] = voc.leaf_map.cpu().numpy()
        if server.kf_bow_words is not None:
            srv["kf_bow_words"] = server.kf_bow_words
            srv["kf_bow_vals"] = server.kf_bow_vals
    np.savez_compressed(
        path, agent_scalars=ag_scalars, agent_has_pose=ag_has_pose,
        agent_q=ag_q, agent_t=ag_t, **arrays,
        **{f"srv_{k}": v for k, v in srv.items()})


def load_atlas(system, path: str, server=None) -> None:
    """Restore the map state onto the system's device, the agents and,
    with a server, its vocabulary and keyframe database.  Fields that
    older files lack are filled as the reference fills them."""
    data = np.load(path)
    fields = {}
    for name in S.MapState._fields:
        if f"ms_{name}" in data:
            fields[name] = data[f"ms_{name}"]
        elif name == "kf_seq":
            # files from before slot recycling: slots were append-only, so
            # the slot order is the insertion order
            kf_valid = data["ms_kf_valid"]
            fields[name] = np.where(kf_valid,
                                    np.arange(len(kf_valid), dtype=np.int32),
                                    np.int32(S.BIG_SEQ))
        elif name in ("loop_i", "loop_j", "loop_valid"):
            L = OLD_FILE_LOOP_EDGES
            fields[name] = (np.zeros(L, bool) if name == "loop_valid"
                            else np.full(L, -1, np.int32))
        elif name in ("mp_first_agent", "mp_first_agent_kf"):
            # files from before agent-aware point culling
            fields[name] = np.full(data["ms_mp_valid"].shape[0], -1,
                                   np.int32)
        else:
            raise KeyError(f"checkpoint missing MapState field {name}")
    system.ms = S.MapState(**{k: torch.from_numpy(np.array(v)).to(
        system.device) for k, v in fields.items()})

    ag = data["agent_scalars"]
    for i in range(len(ag)):
        while len(system.agents) <= i:
            system.add_agent()
        a = system.agents[i]
        _, a.state, a.map_id, a.ref_kf, a.next_agent_kf_id = (
            int(v) for v in ag[i])
        # no chain and no velocity: the next frame uploads the host pose
        a.dev_chain = None
        a.vel_q = a.vel_t = None
        if data["agent_has_pose"][i]:
            a.q = np.array(data["agent_q"][i], np.float32)
            a.t = np.array(data["agent_t"][i], np.float32)

    if server is not None and "srv_voc_idf" in data:
        k, depth = (int(v) for v in data["srv_voc_meta"])
        dev = system.device
        server.voc = bow.Vocabulary(
            centroid_bits=tuple(
                torch.from_numpy(data[f"srv_voc_level_{i}"].astype(np.uint8))
                .to(dev) for i in range(depth)),
            idf=torch.from_numpy(data["srv_voc_idf"]).to(dev), k=k,
            depth=depth,
            leaf_map=(torch.from_numpy(data["srv_voc_leaf_map"]).to(dev)
                      if "srv_voc_leaf_map" in data else None))
        if "srv_kf_bow_words" in data:
            server.kf_bow_words = np.array(data["srv_kf_bow_words"])
            server.kf_bow_vals = np.array(data["srv_kf_bow_vals"])
