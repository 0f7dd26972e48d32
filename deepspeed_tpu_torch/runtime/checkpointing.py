"""Synchronous checkpoint save and load: the port of
``deepspeed_tpu/runtime/checkpointing.py``.

The reference's layout: a tag directory (``global_step{N}`` by default)
under ``save_dir`` with a ``latest`` pointer file beside it, and in the tag
directory ``ds_meta.json``, ``client_state.pkl``, ``lr_scheduler.json``
and ``state/``. The model and the optimizer states are apart, so a model
loads without its optimizer state (``load_optimizer_states=False``).

One departure: the JAX package writes ``state/`` through orbax; the port
writes it with the resilience tier's shard writer
(``resilience/checkpoint.write_snapshot``: raw shards, a JSON manifest
with a sha256 per shard), the one serialisation the port has and the
format both packages read. ``consolidate_to_fp32`` (the reference's
``zero_to_fp32``) returns the fp32 masters under the port's names.
"""

import json
import os
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger

LATEST_FILE = "latest"
STATE_SUBDIR = "state"
META_FILE = "ds_meta.json"
CLIENT_STATE_FILE = "client_state.pkl"
SCHED_FILE = "lr_scheduler.json"


def _tag_dir(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, str(tag))


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None,
                    save_latest: bool = True) -> str:
    """Write a checkpoint; returns the tag directory path."""
    from deepspeed_tpu_torch.resilience.checkpoint import (snapshot_engine,
                                                           write_snapshot)

    if tag is None:
        tag = f"global_step{engine.global_steps}"
    path = _tag_dir(save_dir, tag)
    state_dir = os.path.join(path, STATE_SUBDIR)
    os.makedirs(state_dir, exist_ok=True)
    t0 = time.monotonic()
    write_snapshot(snapshot_engine(engine), state_dir)
    meta = {
        "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "skipped_steps": int(engine.state.skipped_steps),
        "zero_stage": engine.config.zero_config.stage,
        "precision": engine.precision.name,
        "dp_world_size": 1,
        "world_size": 1,
        "gradient_accumulation_steps": engine.gradient_accumulation_steps,
        "ds_version": _version(),
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(path, CLIENT_STATE_FILE), "wb") as f:
        pickle.dump(client_state or {}, f)
    if engine.lr_scheduler is not None:
        with open(os.path.join(path, SCHED_FILE), "w") as f:
            json.dump(engine.lr_scheduler.state_dict(), f)
    if save_latest:
        with open(os.path.join(save_dir, LATEST_FILE), "w") as f:
            f.write(str(tag))
    log_dist(f"saved checkpoint {path} ({time.monotonic() - t0:.3f} s)",
             ranks=[0])
    return path


def _resolve_tag(load_dir: str, tag: Optional[str]) -> Optional[str]:
    if tag is not None:
        return tag
    latest = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return f.read().strip()


def _read_state(state_dir: str, names=None) -> Dict[str, np.ndarray]:
    from deepspeed_tpu_torch.resilience.checkpoint import (_read_manifest,
                                                           read_shards)

    return read_shards(state_dir, _read_manifest(state_dir), names)


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True):
    """Restore the engine's state; returns (path, client_state), or
    (None, {}) when ``load_dir`` has no ``latest`` file. Without
    ``load_optimizer_states`` the engine keeps its own optimizer state
    (the moments a fresh engine starts from)."""
    from deepspeed_tpu_torch.resilience.checkpoint import \
        install_state_arrays

    tag = _resolve_tag(load_dir, tag)
    if tag is None:
        logger.warning(f"no 'latest' file in {load_dir}; nothing restored")
        return None, {}
    path = _tag_dir(load_dir, tag)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint dir not found: {path}")
    keep = () if load_optimizer_states else ("opt_state.",)
    arrays = _read_state(os.path.join(path, STATE_SUBDIR),
                         lambda n: not n.startswith(keep))
    meta = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    install_state_arrays(engine, arrays,
                         step=int(meta.get("global_steps", 0)),
                         micro_steps=int(meta.get("micro_steps", 0)),
                         keep_prefixes=keep)
    client_state: Dict[str, Any] = {}
    cs_path = os.path.join(path, CLIENT_STATE_FILE)
    if os.path.exists(cs_path):
        with open(cs_path, "rb") as f:
            client_state = pickle.load(f)
    if load_lr_scheduler_states and engine.lr_scheduler is not None:
        sp = os.path.join(path, SCHED_FILE)
        if os.path.exists(sp):
            with open(sp) as f:
                engine.lr_scheduler.load_state_dict(json.load(f))
    log_dist(f"loaded checkpoint {path}", ranks=[0])
    return path, client_state


def _version() -> str:
    from deepspeed_tpu_torch.version import __version__

    return __version__


def _params_from_state(state_dir: str) -> Dict[str, np.ndarray]:
    """The ``params.*`` shards of a state directory, under the module's
    names, digest-verified; the other shards are not read."""
    arrays = _read_state(state_dir, lambda n: n.startswith("params."))
    return {k[len("params."):]: v for k, v in arrays.items()}


def load_module_params(load_dir: str, tag: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """Only the model's fp32 masters of a training checkpoint, as a
    ``state_dict`` (the inference engine's ``checkpoint=`` path). No
    engine or optimizer state is built, and the other shards are not
    read. ``load_dir`` may be the save directory (with ``latest``) or a
    tag directory."""
    if tag is None:
        tag = _resolve_tag(load_dir, None)
        if tag is None:
            if not os.path.isdir(os.path.join(load_dir, STATE_SUBDIR)):
                raise FileNotFoundError(
                    f"no '{LATEST_FILE}' file in {load_dir} and it is not "
                    f"a tag directory (no '{STATE_SUBDIR}/' inside); pass "
                    f"tag= or point at a checkpoint written by "
                    f"save_checkpoint")
            tag = ""    # load_dir is itself a tag directory
    path = os.path.join(_tag_dir(load_dir, tag) if tag else load_dir,
                        STATE_SUBDIR)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint state dir not found: {path}")
    return {k: torch.from_numpy(v)
            for k, v in _params_from_state(path).items()}


# ---------------------------------------------------------------------------
# zero_to_fp32 (reference utils/zero_to_fp32.py)
# ---------------------------------------------------------------------------

def consolidate_to_fp32(checkpoint_dir: str, tag: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """Offline: a checkpoint's fp32 master params as a flat dict, without
    building an engine. The shards hold whole tensors (one process), so
    there is nothing to merge."""
    if tag is None:
        with open(os.path.join(checkpoint_dir, LATEST_FILE)) as f:
            tag = f.read().strip()
    state_dir = os.path.join(_tag_dir(checkpoint_dir, tag), STATE_SUBDIR)
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in _params_from_state(state_dir).items()}


def zero_to_fp32_main(argv=None) -> int:
    """``zero_to_fp32``: consolidate a checkpoint into a flat fp32
    ``.npz`` without building an engine (the reference's standalone
    script, as a callable)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint to fp32")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output_file", help="destination .npz")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    flat = consolidate_to_fp32(args.checkpoint_dir, tag=args.tag)
    np.savez(args.output_file, **flat)
    total = sum(v.size for v in flat.values())
    print(f"wrote {len(flat)} tensors ({total / 1e6:.1f}M params) "
          f"to {args.output_file}")
    return 0
