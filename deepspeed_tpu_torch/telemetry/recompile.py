"""First-call-at-a-new-signature detector.

The port of ``deepspeed_tpu/telemetry/recompile.py``. The JAX package
fingerprints what its jit cache keys on and warns when a step function
retraces. The port runs eagerly, so nothing is traced; the counterpart of
a retrace is the first call of a step at a new input signature, where the
card pays a new cuBLAS plan or builds a kernel at first use, and where a
serving engine meets a new prompt bucket or decode window. The detector
keys on the same things the reference's does, read off tensors: each
leaf's (path, shape, dtype, device), walking dicts (in sorted key order,
as ``jax.tree_util`` flattens them), lists and tuples; a string leaf is a
static input whose value is part of the signature, and a Python number's
type (not its value) is. On the same call sequence it gives the
reference's verdicts at the same call sites and steps:

- the first signature of a function is the expected ``"compile"``;
- a repeated signature is a ``"hit"``;
- a new signature after the first is a ``"retrace"``: a warning names the
  function and the leaves that changed, the ``telemetry/recompiles``
  counter grows, and the tracer gets an instant event.

Fingerprinting is host-side tuple hashing over tensor metadata: no device
work and no sync.
"""

import threading
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger

RECOMPILE_COUNTER = "telemetry/recompiles"


def _leaf_sig(name: str, leaf) -> Tuple[str, str, str, str]:
    """(path, shape, dtype, device) of one leaf."""
    shape = getattr(leaf, "shape", None)
    if shape is None:
        if isinstance(leaf, str):
            return (name, "static", leaf, "-")
        return (name, "scalar", type(leaf).__name__, "-")
    dtype = str(getattr(leaf, "dtype", "-")).replace("torch.", "")
    device = getattr(leaf, "device", None)
    return (name, str(tuple(shape)), dtype,
            str(device) if device is not None else "host")


def _flatten(tree, path: Tuple[str, ...], out: List) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, path + (str(i),), out)
    else:
        out.append(("/".join(path), tree))


def tree_signature(*trees) -> Tuple[Tuple[str, str, str, str], ...]:
    sig: List[Tuple[str, str, str, str]] = []
    for i, tree in enumerate(trees):
        leaves: List[Any] = []
        _flatten(tree, (), leaves)
        for name, leaf in leaves:
            _name, shape, dtype, dev = _leaf_sig(name, leaf)
            sig.append((f"arg{i}.{name}", shape, dtype, dev))
    return tuple(sig)


class RecompileDetector:
    """Per-function signature cache and retrace accounting."""

    def __init__(self, registry=None, tracer=None, enabled: bool = True,
                 warn: bool = True):
        self.enabled = bool(enabled)
        self.warn = bool(warn)
        self.registry = registry
        self.tracer = tracer
        self._lock = threading.Lock()
        # fn -> {signature hash: signature}
        self._seen: Dict[str, Dict[int, Tuple]] = {}
        self.stats: Dict[str, Dict[str, int]] = {}

    def check(self, fn_name: str, *trees, step: Optional[int] = None) -> str:
        """``"compile"`` (the first signature), ``"hit"`` (seen before) or
        ``"retrace"`` (a new signature after the first; warned)."""
        if not self.enabled:
            return "hit"
        sig = tree_signature(*trees)
        key = hash(sig)
        with self._lock:
            seen = self._seen.setdefault(fn_name, {})
            st = self.stats.setdefault(fn_name,
                                       {"compiles": 0, "retraces": 0})
            if key in seen:
                return "hit"
            first = not seen
            prev = next(reversed(seen.values())) if seen else None
            seen[key] = sig
            st["compiles"] += 1
            if first:
                return "compile"
            st["retraces"] += 1
        self._report(fn_name, prev, sig, step)
        return "retrace"

    def forget(self, fn_name: str) -> None:
        """Drop every signature of ``fn_name``: its next call counts as the
        expected first one (for expected changes only)."""
        with self._lock:
            self._seen.pop(fn_name, None)

    def _report(self, fn_name: str, prev: Optional[Tuple], sig: Tuple,
                step: Optional[int]) -> None:
        changed = self._diff(prev, sig)
        if self.registry is not None:
            self.registry.counter(RECOMPILE_COUNTER).inc(step=step,
                                                         fn=fn_name)
        if self.tracer is not None:
            self.tracer.instant("recompile", fn=fn_name,
                                changed=changed[:8])
        if self.warn:
            logger.warning(
                "NEW SIGNATURE: step %r was called%s with inputs it has not "
                "seen (a new cuBLAS plan or kernel build on the card, a new "
                "bucket or window in serving). Changed inputs: %s. "
                "Stabilize input shapes/dtypes/devices (pad ragged batches, "
                "drop the short final batch).", fn_name,
                f" at step {step}" if step is not None else "",
                "; ".join(changed[:8]) if changed else "<signature length>")

    @staticmethod
    def _diff(prev: Optional[Tuple], sig: Tuple) -> List[str]:
        if prev is None:
            return []
        prev_map = {e[0]: e for e in prev}
        out = []
        for entry in sig:
            old = prev_map.get(entry[0])
            if old is None:
                out.append(f"{entry[0]}: new leaf "
                           f"{entry[1]}/{entry[2]}/{entry[3]}")
            elif old != entry:
                out.append(
                    f"{entry[0]}: {old[1]}/{old[2]}/{old[3]} -> "
                    f"{entry[1]}/{entry[2]}/{entry[3]}")
        new_names = {e[0] for e in sig}
        out.extend(f"{e[0]}: leaf removed" for e in prev
                   if e[0] not in new_names)
        return out

    def compiles(self, fn_name: str) -> int:
        return self.stats.get(fn_name, {}).get("compiles", 0)

    def retraces(self, fn_name: Optional[str] = None) -> int:
        if fn_name is not None:
            return self.stats.get(fn_name, {}).get("retraces", 0)
        return sum(s["retraces"] for s in self.stats.values())
