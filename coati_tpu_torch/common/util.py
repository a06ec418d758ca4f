"""Small host-side utilities (own copies of coati_tpu/common/util.py's,
plus the device rule of the port's entry points)."""

from __future__ import annotations

import datetime
import os
import shutil
import sys
from datetime import timezone

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
