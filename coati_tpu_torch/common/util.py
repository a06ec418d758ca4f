"""Small host-side utilities (own copies of coati_tpu/common/util.py's,
plus the device rule of the port's entry points)."""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import shutil
import signal
import sys
from datetime import timezone
from itertools import product

import numpy as np
import torch


def dir_or_file_exists(path: str) -> bool:
    return os.path.exists(path)


def batch_indexable(iterable, n: int = 128):
    """Yield length-n slices of an indexable sequence."""
    total = len(iterable)
    for start in range(0, total, n):
        yield iterable[start : min(start + n, total)]


def rmdir(path: str) -> None:
    """Remove a directory tree; a failure is printed, not raised."""
    try:
        shutil.rmtree(path)
    except OSError as ex:
        print("rmdir failure", ex)


def query_yes_no(question: str, default=None) -> bool:
    """Interactive y/n prompt (yes without asking when COATI_TPU_ASSUME_YES=1
    or stdin is not a terminal)."""
    if os.environ.get("COATI_TPU_ASSUME_YES") == "1" or not sys.stdin.isatty():
        return True
    valid = {"yes": True, "y": True, "ye": True, "no": False, "n": False}
    prompt = {None: " [y/n] ", "yes": " [Y/n] ", "no": " [y/N] "}[default]
    while True:
        sys.stdout.write(question + prompt)
        choice = input().lower()
        if default is not None and choice == "":
            return valid[default]
        if choice in valid:
            return valid[choice]
        sys.stdout.write("Please respond with 'yes' or 'no' (or 'y'/'n').\n")


def utc_epoch_now() -> float:
    return datetime.datetime.now().replace(tzinfo=timezone.utc).timestamp()


def makedir(path: str, isfile: bool = False) -> None:
    """mkdir -p; if isfile, create the parent directory of the given file path."""
    if isfile:
        path = os.path.dirname(path)
    if path != "":
        os.makedirs(path, exist_ok=True)


def colored_background(r: int, g: int, b: int, text: str) -> str:
    """ANSI 24-bit background color wrapper (r, g, b in [0, 255])."""
    return f"\033[48;2;{r};{g};{b}m{text}\033[0m"


def tensor_of_dict_of_lists(d: dict) -> list:
    """The tensor (Cartesian) product of a dict of lists: one dict for each
    combination of its values, the last key varying fastest."""
    keys = list(d.keys())
    return [dict(zip(keys, combo)) for combo in product(*d.values())]


class NpEncoder(json.JSONEncoder):
    """JSON encoder that takes numpy scalars and arrays (and anything with
    .tolist, such as a torch tensor)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray) or hasattr(obj, "tolist"):
            return obj.tolist()
        return super().default(obj)


def json_valid_dict(obj):
    """`obj` with numpy values turned into plain JSON types."""
    return json.loads(json.dumps(obj, cls=NpEncoder))


class OnlineEstimator:
    """Running mean and variance without storage (Welford / Knuth)."""

    def __init__(self, x):
        self.n = 1
        self.mean = x * 0.0
        self.m2 = x * 0.0
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    def __call__(self, x):
        """Adds x; returns (mean, sample variance) so far."""
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)
        return self.mean, self.m2 / (self.n - 1)


def records_mp(recs, func, args=None, n=None):
    """func(chunk, *args) over chunks of `recs` in a pool of n spawned
    processes (func and args are pickled: a function importable by name);
    the chunks' outputs joined in order."""
    if n is None:
        n = min(mp.cpu_count(), len(recs))
    args = tuple(args or ())
    mp_args = [(chunk, *args) for chunk in batch_indexable(recs, n)]
    with mp.get_context("spawn").Pool(processes=n) as pool:
        out = pool.starmap(func, mp_args)
    flat = [rec for chunk in out for rec in chunk]
    assert len(flat) == len(recs)
    return flat


def execute_with_timeout(method, args, timeout):
    """method(*args) under a SIGALRM of `timeout` seconds (main thread
    only); None when it expires."""
    result = None

    def handler(signum, frame):
        raise TimeoutError("Execution timed out")

    signal.signal(signal.SIGALRM, handler)
    signal.alarm(timeout)
    try:
        result = method(*args)
    except TimeoutError:
        pass
    finally:
        signal.alarm(0)
    return result


def dicts_to_keyval(list_of_dicts, key: str, value: str) -> dict:
    return {d[key]: d[value] for d in list_of_dicts}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another (the tests pass "cpu"). Without a card and without an
    explicit device this raises; it never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: coati_tpu_torch runs on the GPU; pass device='cpu' "
                "to run on the CPU explicitly"
            )
        device = "cuda"
    return torch.device(device)
