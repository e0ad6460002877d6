"""Small shared pieces: seeds, cache directories, the result line, the
check for forbidden modules, the card's power limit, and the run's host
side: its threads bound to the CPUs local to the card, and set-up's
objects kept out of the window's garbage collections."""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import time

# top-level module names that no process of a run may hold: JAX and the
# JAX package this repository ports (compared whole, so `repro_torch`,
# the program under test, is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, table, traffic, ...) drawn
    from the run's seed: the same pair gives the same seed in every
    process."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(torch, seed: int, purpose: str, device):
    """A torch.Generator on `device` seeded for `purpose`."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def set_cache_dirs(root: pathlib.Path) -> None:
    """Point every build and kernel cache the program might use at fixed
    directories inside the checkout (before torch is imported), so that
    only a cell's first run in a checkout builds or compiles. The port's
    own nvcc build is fixed in its code at `build/repro_torch_kernels`,
    which is inside the checkout too."""
    base = root / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = base / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # a library that would load JAX by itself must not
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that `sys.modules` holds."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reports them, or
    why they could not be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return " | ".join(line.strip() for line in out.stdout.splitlines())


def card_pci_address(torch, index: int = 0) -> str | None:
    """The sysfs name (`dddd:bb:dd.0`) of CUDA card `index`, from the
    device properties' PCI ids; None where torch has none."""
    props = torch.cuda.get_device_properties(index)
    ids = [getattr(props, f"pci_{k}_id", None)
           for k in ("domain", "bus", "device")]
    if None in ids:
        return None
    return "{:04x}:{:02x}:{:02x}.0".format(*ids)


def parse_cpulist(text: str) -> list[int]:
    """The CPUs of a sysfs cpulist such as "0-15,32-47", sorted."""
    cpus = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return sorted(cpus)


def format_cpulist(cpus) -> str:
    """`parse_cpulist`'s inverse: [0, 1, 2, 5] -> "0-2,5"."""
    out, cpus = [], sorted(cpus)
    i = 0
    while i < len(cpus):
        j = i
        while j + 1 < len(cpus) and cpus[j + 1] == cpus[j] + 1:
            j += 1
        out.append(str(cpus[i]) if i == j else f"{cpus[i]}-{cpus[j]}")
        i = j + 1
    return ",".join(out)


@dataclasses.dataclass
class HostSide:
    """Where a run's threads may run: `cpus`, the card's NUMA node (None
    where sysfs gives none) and how the list was found."""

    cpus: list
    node: int | None
    how: str


def card_local_cpus(pci: str | None,
                    devices: pathlib.Path = pathlib.Path(
                        "/sys/bus/pci/devices")) -> HostSide:
    """The CPUs local to the card at `pci` that this process may use, from
    sysfs's `local_cpulist` and `numa_node`; where there is no such list
    (no address, no file, or none of its CPUs allowed here), the CPUs the
    process already has."""
    have = sorted(os.sched_getaffinity(0))
    node = None
    if pci is None:
        return HostSide(have, None, "fallback: no PCI address for the card")
    try:
        node = int((devices / pci / "numa_node").read_text())
    except (OSError, ValueError):
        pass
    if node is not None and node < 0:
        node = None
    try:
        local = parse_cpulist((devices / pci / "local_cpulist").read_text())
    except (OSError, ValueError) as e:
        return HostSide(have, node, f"fallback: no local_cpulist ({e})")
    cpus = sorted(set(local) & set(have))
    if not cpus:
        return HostSide(have, node, "fallback: no card-local CPU allowed")
    return HostSide(cpus, node, "card-local")


def pin_host(torch, index: int = 0) -> HostSide:
    """Bind every thread of this process to the CPUs local to CUDA card
    `index` (as `numactl --cpunodebind` does for a job started on the
    card's node); threads started later inherit the binding. Acts on this
    process alone."""
    host = card_local_cpus(card_pci_address(torch, index))
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), host.cpus)
        except (ProcessLookupError, PermissionError):
            pass        # a thread that ended, or one not ours to move
    return host


def last_cpu() -> int | None:
    """The CPU the main thread last ran on (`/proc/self/stat`, field 39)."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
    except OSError:
        return None
    # the command name (field 2) may hold spaces: count after its ")"
    return int(stat.rpartition(")")[2].split()[36])


def host_line(host: HostSide, p50_ms: float | None) -> str:
    """The line each run logs about its host side."""
    node = "unknown" if host.node is None else host.node
    p50 = "none" if p50_ms is None else f"{p50_ms:.3f} ms"
    return (f"[host] cpus {format_cpulist(host.cpus)} node {node} "
            f"({host.how}); main thread last on cpu {last_cpu()}; "
            f"window p50 step {p50}")


def end_setup(t0: float) -> float:
    """Set-up's end: its garbage collected and what it built frozen out of
    later collections (`gc.freeze`), so the window's collections walk the
    window's own objects only; collection stays on. Returns the seconds
    since `t0`. `gc.unfreeze()` once the window is over."""
    gc.collect()
    gc.freeze()
    return time.perf_counter() - t0


def step_p50_ms(stamps: list) -> float | None:
    """The median of the times between successive `stamps`, in ms."""
    ms = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    return ms[(len(ms) - 1) // 2] if ms else None


def device(torch, ctx):
    """The run's device: the card, or the CPU in the tests."""
    if ctx.device == "cuda":
        return torch.device("cuda", 0)
    return torch.device("cpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Patch:
    """Attributes (or mapping items) replaced for one run, and put back
    by `undo`: how a fault is planted in the program."""

    def __init__(self):
        self.saved = []

    def set(self, obj, key, value, item: bool = False):
        old = obj[key] if item else getattr(obj, key)
        self.saved.append((obj, key, old, item))
        if item:
            obj[key] = value
        else:
            setattr(obj, key, value)

    def undo(self):
        for obj, key, old, item in reversed(self.saved):
            if item:
                obj[key] = old
            else:
                setattr(obj, key, old)
        self.saved.clear()
