"""Device placement for the Sebulba actor/learner split (the port of
torchbeast_tpu/runtime/placement.py).

The Podracer paper's Sebulba architecture (arXiv:2104.06272, PAPERS.md)
realizes IMPALA's acting/learning decoupling on the accelerator
topology: the devices are partitioned into dedicated INFERENCE slices
(each serving acting requests from a pinned policy snapshot) and a
LEARNER group that owns the update step, so a big update never
time-shares a device with latency-sensitive acting batches. This module
is the partitioning half of that story: `resolve_device_split` turns the
`--device_split` flag into a `DeviceSplit` over a device list, and the
split carries the STATIC actor->slice assignment (hash-by-slot) that
keeps each actor's device-resident state-table slot on one slice for the
life of the run.

Torch-free: callers pass the device list in (the drivers pass
`parallel.visible_devices(...)`, a list of `torch.device`s; tests pass
whatever they like), so parsing and validation need no backend.

Spec grammar (`--device_split`):

- `""` / unset      -> no split: the time-shared path.
- `auto`            -> 1 of every AUTO_INFERENCE_FRACTION devices (at
                       least one) serves inference, the rest learn;
                       a single-device process degrades to time-shared.
- `inf=K,learn=rest`-> K single-device inference slices, every
                       remaining device in the learner group.
- `inf=K,learn=M`   -> K inference slices, exactly M learner devices
                       (K + M <= device count; surplus devices idle).

Each inference device is ONE slice: acting models are small and
replicated, so a slice never needs more than a device, and one
DeviceStateTable + serving loop per slice keeps the pinning checkable
(every table tensor lives on its slice's device).

The error texts, the warning on a single device and the hash are the
reference's. `describe()` reports each device's `index` where the
reference reports its `.id`; a device without one (the CPU, whose
devices are all `torch.device("cpu")`) reports its position in the list
the split was resolved from, which is what the reference's CPU device
ids are.
"""

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

log = logging.getLogger(__name__)

# `auto` pins 1 of every 4 devices to inference (floor, min 1), the
# Sebulba paper's starting ratio for small acting models; explicit
# `inf=K` specs override it per topology.
AUTO_INFERENCE_FRACTION = 4


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a deterministic, process-stable integer
    hash (Python's builtin hash() is salted per process, which would
    re-shuffle the actor->slice map on every restart)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


# Salt for the SECOND splitmix64 stage of the fleet's actor->host
# assignment: host = _mix64(slot ^ salt) % n_hosts while
# slice = _mix64(slot) % n_slices. The salt decorrelates the two draws:
# without it every slot on host h would also share slice h % n_slices
# whenever n_hosts == n_slices. Any fixed odd constant works; this one is
# the splitmix64 gamma rotated left by 1 (the gamma itself would
# correlate the host draw with the slice draw's first addition).
FLEET_HOST_SALT = 0x3C6EF372FE94F82B


def fleet_host_for_slot(slot: int, num_hosts: int) -> int:
    """STATIC slot -> host assignment for multi-host fleets: the same
    process-stable splitmix64 family as `DeviceSplit.slice_for_slot`,
    salted so the host draw and the slice draw are uncorrelated. A slot's
    (host, slice) pair therefore never migrates across actor reconnects
    or host restarts."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    return _mix64(int(slot) ^ FLEET_HOST_SALT) % num_hosts


def _device_id(device, position: int) -> int:
    """A device's `index` (torch) or `.id` (any other device object), else
    its position in the resolved list."""
    index = getattr(device, "index", None)
    if index is None:
        index = getattr(device, "id", None)
    return position if index is None else int(index)


@dataclasses.dataclass(frozen=True)
class DeviceSplit:
    """A resolved device partition: N single-device inference slices +
    the learner device group. `first_learner` is the learner group's
    position in the list the split was resolved from (describe()'s ids
    of index-less devices)."""

    spec: str
    inference_devices: Tuple
    learner_devices: Tuple
    first_learner: Optional[int] = None

    def __post_init__(self):
        if not self.inference_devices or not self.learner_devices:
            raise ValueError(
                "a DeviceSplit needs at least one inference device and "
                "one learner device (use no split for single-device)"
            )

    @property
    def n_slices(self) -> int:
        return len(self.inference_devices)

    def slice_for_slot(self, slot: int) -> int:
        """STATIC slot -> slice assignment: a deterministic hash of the
        slot id (== actor index == connection identity in the pool), so
        an actor's table slot lives on one slice for the whole run,
        across reconnects, serving-thread restarts and process restarts,
        and slot state never migrates between devices."""
        return _mix64(int(slot)) % self.n_slices

    def device_for_slot(self, slot: int):
        return self.inference_devices[self.slice_for_slot(slot)]

    def describe(self) -> dict:
        """JSON-serializable summary (the `device_split` telemetry
        static)."""
        first = (self.n_slices if self.first_learner is None
                 else self.first_learner)
        return {
            "spec": self.spec,
            "inference_slices": self.n_slices,
            "learner_devices": len(self.learner_devices),
            "inference_device_ids": [
                _device_id(d, i)
                for i, d in enumerate(self.inference_devices)
            ],
            "learner_device_ids": [
                _device_id(d, first + i)
                for i, d in enumerate(self.learner_devices)
            ],
        }


def parse_device_split(spec: Optional[str]) -> Optional[dict]:
    """Validate the flag grammar without touching devices.

    Returns None (no split), or {"inf": int | "auto", "learn":
    int | "rest"}. Raises ValueError on a malformed spec, at flag
    parse time, before any side effects.
    """
    if spec is None:
        return None
    spec = spec.strip()
    if not spec:
        return None
    if spec == "auto":
        return {"inf": "auto", "learn": "rest"}
    parts = dict()
    for piece in spec.split(","):
        if "=" not in piece:
            raise ValueError(
                f"--device_split piece {piece!r} is not key=value "
                "(expected 'auto' or 'inf=K,learn=rest|M')"
            )
        key, _, value = piece.partition("=")
        key = key.strip()
        if key not in ("inf", "learn"):
            raise ValueError(
                f"--device_split key {key!r} unknown (inf/learn)"
            )
        if key in parts:
            raise ValueError(f"--device_split repeats {key!r}")
        parts[key] = value.strip()
    if "inf" not in parts:
        raise ValueError("--device_split needs inf=K")
    try:
        n_inf = int(parts["inf"])
    except ValueError:
        raise ValueError(
            f"--device_split inf={parts['inf']!r} is not an integer"
        ) from None
    if n_inf < 1:
        raise ValueError(f"--device_split inf={n_inf} must be >= 1")
    learn = parts.get("learn", "rest")
    if learn != "rest":
        try:
            learn = int(learn)
        except ValueError:
            raise ValueError(
                f"--device_split learn={learn!r} is neither 'rest' nor "
                "an integer"
            ) from None
        if learn < 1:
            raise ValueError(
                f"--device_split learn={learn} must be >= 1"
            )
    return {"inf": n_inf, "learn": learn}


def validate_split_composition(
    flags, split: Optional[DeviceSplit],
    parallel_flags: Sequence[str],
) -> None:
    """The composition rules BOTH drivers enforce before any side
    effects (one definition, so a rule added for one driver cannot be
    missing from the other): no inner-parallelism flags alongside the
    split, --num_learner_devices must agree with the split's learner
    group when both are given, and the batch must divide over the learner
    devices. Driver-specific rules (polybeast's multi-process refusal,
    monobeast's fused-tail check) stay at their call sites."""
    if split is None:
        return
    for f in parallel_flags:
        if (getattr(flags, f, 0) or 0) > 1:
            raise ValueError(
                f"--device_split does not compose with --{f} yet "
                "(the split's learner mesh is plain DP over the "
                "learner devices)"
            )
    n_learn = len(split.learner_devices)
    n_dev = getattr(flags, "num_learner_devices", 1) or 1
    if n_dev > 1 and n_dev != n_learn:
        raise ValueError(
            f"--num_learner_devices {n_dev} conflicts with "
            f"--device_split's {n_learn} learner devices (drop the "
            "flag: the split sizes the mesh)"
        )
    if flags.batch_size % n_learn != 0:
        raise ValueError(
            f"--batch_size {flags.batch_size} not divisible by the "
            f"split's {n_learn} learner devices"
        )


def resolve_device_split(
    spec: Optional[str], devices: Sequence
) -> Optional[DeviceSplit]:
    """Resolve the flag against a concrete device list.

    Returns None for no-split AND for the single-device degradation:
    on one device there is nothing to partition, so any spec (auto or
    explicit) falls back to the time-shared path with a log line: the
    same command runs on one device and on many.
    """
    parsed = parse_device_split(spec)
    if parsed is None:
        return None
    n = len(devices)
    if n < 2:
        log.warning(
            "--device_split %s on a single visible device: degrading "
            "to the time-shared serving path (the split needs >= 2 "
            "devices).", spec,
        )
        return None
    if parsed["inf"] == "auto":
        n_inf = max(1, n // AUTO_INFERENCE_FRACTION)
    else:
        n_inf = parsed["inf"]
    if n_inf >= n and parsed["learn"] == "rest":
        raise ValueError(
            f"--device_split inf={n_inf} leaves no learner device "
            f"({n} visible)"
        )
    if parsed["learn"] == "rest":
        n_learn = n - n_inf
    else:
        n_learn = parsed["learn"]
        if n_inf + n_learn > n:
            raise ValueError(
                f"--device_split inf={n_inf},learn={n_learn} needs "
                f"{n_inf + n_learn} devices; {n} visible"
            )
    split = DeviceSplit(
        spec=str(spec).strip(),
        inference_devices=tuple(devices[:n_inf]),
        learner_devices=tuple(devices[n_inf:n_inf + n_learn]),
        first_learner=n_inf,
    )
    desc = split.describe()
    log.info(
        "Device split: %d inference slice(s) %s + %d learner device(s) "
        "%s", split.n_slices, desc["inference_device_ids"],
        len(split.learner_devices), desc["learner_device_ids"],
    )
    return split
