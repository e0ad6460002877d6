"""Small shared pieces: seeds, cache directories, the result line, the
check for forbidden modules and the card's power limit."""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

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
