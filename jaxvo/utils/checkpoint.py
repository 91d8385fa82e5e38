"""Checkpoint / resume for the VO state (SURVEY.md §5: absent in the
reference, whose only persistence is the end-of-run artifact dump).

Two backends over the same tree layout:

* ``save_state`` / ``load_state`` — a single .npz per checkpoint. The VO
  state is a small pytree (pose + fixed-capacity map + counters), so this
  is sufficient and dependency-free; the sharded BA state reuses the same
  format per shard.
* ``OrbaxCheckpointer`` — orbax-backed, for multi-host / sharded states:
  each host writes only its addressable shards, restore honors a target
  sharding, and retention keeps the last N steps. This is the path a pod
  deployment uses; the npz path is the single-host default.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from jaxvo.engine.state import VOState


def _backfill_vostate_fields(sdict: dict, cls) -> dict:
    """Defaults for VOState fields added after a checkpoint was written
    (mirrors load_state's npz shims; no-op when nothing is missing)."""
    if cls is not VOState or set(sdict) >= set(VOState._fields):
        return sdict
    sdict = dict(sdict)
    if "vel" not in sdict:
        sdict["vel"] = np.eye(4, dtype=np.float32)
    if "map_last_seen" not in sdict:
        sdict["map_last_seen"] = np.zeros(
            np.asarray(sdict["map_valid"]).shape, np.int32)
    if "frame_idx" not in sdict:
        sdict["frame_idx"] = np.int32(0)
    return sdict


def save_state(path: str, state: VOState, frame_idx: int, extra: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"state_{k}": np.asarray(v) for k, v in state._asdict().items()}
    payload["frame_idx"] = np.int32(frame_idx)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_state(path: str):
    """Returns (VOState, frame_idx, extra_dict)."""
    z = np.load(path, allow_pickle=False)
    fields = {k[len("state_"):]: z[k] for k in z.files if k.startswith("state_")}
    import jax.numpy as jnp

    if "vel" not in fields:  # checkpoints written before the vel field
        fields["vel"] = np.eye(4, dtype=np.float32)
    # checkpoints written before the landmark-lifecycle fields
    if "map_last_seen" not in fields:
        fields["map_last_seen"] = np.zeros(fields["map_valid"].shape, np.int32)
    if "frame_idx" not in fields:
        fields["frame_idx"] = np.int32(0)
    state = VOState(**{k: jnp.asarray(v) for k, v in fields.items()})
    extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return state, int(z["frame_idx"]), extra


class OrbaxCheckpointer:
    """Orbax-backed checkpointing of the VO/BA state pytree.

    Supports multi-host sharded states: under ``jax.distributed`` each host
    serializes only the shards it owns, and ``restore`` accepts an abstract
    target (e.g. ``jax.eval_shape`` output with shardings attached) so the
    state comes back resharded onto the live mesh.  Retention keeps the
    newest ``keep`` steps.  Falls back with ImportError if orbax is absent.
    """

    def __init__(self, directory: str, keep: int = 3):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self._mgr = ocp.CheckpointManager(
            os.path.abspath(directory),
            options=ocp.CheckpointManagerOptions(max_to_keep=keep),
        )

    def save(self, step: int, state, extra: dict | None = None):
        """``state``: a VOState or any NamedTuple/dict pytree of arrays
        (e.g. a mesh-sharded BA state — each host writes only the shards
        it owns)."""
        ocp = self._ocp
        payload = {"state": state._asdict() if hasattr(state, "_asdict")
                   else dict(state)}
        # explicit state-type tag: restore(target=None) dispatches on this
        # instead of key-set sniffing (a non-VOState dict with coincident
        # keys must NOT silently come back wrapped as a VOState).  Encoded
        # as a uint8 array — orbax StandardSave rejects raw strings.
        payload["state_type"] = np.frombuffer(
            type(state).__name__.encode(), dtype=np.uint8).copy()
        if extra:
            payload["extra"] = dict(extra)
        self._mgr.save(step, args=ocp.args.StandardSave(payload))
        self._mgr.wait_until_finished()

    def restore(self, step: int | None = None, target=None):
        """Returns (state, extra dict). ``target`` (optional) provides the
        abstract tree — dtypes/shapes/shardings — to restore onto (pass a
        tree of ShapeDtypeStruct with shardings to reshard onto a live
        mesh); the restored state is rebuilt as ``type(target)`` when the
        target is a NamedTuple, else returned as the saved dict/VOState."""
        ocp = self._ocp
        step = self._mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no orbax checkpoint found")
        args = None
        if target is not None:
            tdict = target._asdict() if hasattr(target, "_asdict") else dict(target)
            # orbax StandardRestore requires the restore tree to match the
            # on-disk structure exactly — build the full tree from the
            # checkpoint's own metadata (covers state_type / extra keys
            # the caller doesn't know about) and overlay the caller's
            # target (shapes/dtypes/SHARDINGS) on the "state" entries the
            # checkpoint actually HAS (a newer target may carry fields an
            # old checkpoint lacks — those are backfilled after restore)
            meta = self._mgr.item_metadata(step)
            item = jax.tree.map(
                lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype), dict(meta))
            item["state"] = {
                k: tdict.get(k, v) for k, v in dict(item["state"]).items()}
            args = ocp.args.StandardRestore(item)
        out = self._mgr.restore(step, args=args)
        extra = out.get("extra", {})
        sdict = dict(out["state"])
        if target is not None and hasattr(target, "_asdict"):
            sdict = _backfill_vostate_fields(sdict, type(target))
            return type(target)(**sdict), extra
        saved_type = out.get("state_type")
        if saved_type is not None:
            saved_type = bytes(
                np.asarray(saved_type, dtype=np.uint8)).decode()
        else:
            # pre-tag checkpoints: legacy key-set sniff — accept VOStates
            # saved before the lifecycle fields (backfilled below)
            core = set(VOState._fields) - {"vel", "map_last_seen", "frame_idx"}
            saved_type = ("VOState"
                          if core <= set(sdict) <= set(VOState._fields)
                          else None)
        if target is None and saved_type == "VOState":
            return VOState(**_backfill_vostate_fields(sdict, VOState)), extra
        return sdict, extra

    def latest_step(self):
        return self._mgr.latest_step()

    def close(self):
        self._mgr.close()


def checkpoint_every(run_step, save_path: str, every: int = 25):
    """Wrap a host-side frame loop step with periodic checkpointing."""

    def wrapped(state, frame_idx, *args, **kw):
        state, out = run_step(state, frame_idx, *args, **kw)
        if frame_idx % every == 0:
            save_state(save_path, state, frame_idx)
        return state, out

    return wrapped
