"""Restart checkpoints: save(step, state), restore_latest(template).

Counterpart of coati_tpu/training/checkpoints.py, whose manager wraps
orbax. This one writes each step as one `torch.save` file `<step>.pt` in
the directory and reads it back with `torch.load(weights_only=True)`, so
a state is a nest of dicts, lists and tuples of tensors, numbers, strings
and None. A step is written to a temporary file and
renamed into place, so a crash never leaves a partial `<step>.pt` for
`latest_step` to pick; a stray temporary file is ignored. The step rules
are coati_tpu's: a save older than the latest step is skipped, and a save
at the latest step is written as the next step. With `async_save` the
tensors are copied to the host at `save` and written by a thread; `wait`
joins it and raises its error.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, List, Optional

import torch

from coati_tpu_torch.common.util import makedir

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _to_host(tree):
    """A copy of `tree` with every tensor on the CPU, sharing no storage
    with the live state."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _like(template, restored):
    """`restored` with each tensor on the device of the template's tensor
    at the same place. Leaves the template lacks (an optimizer's state
    before its first step) stay on the CPU."""
    if isinstance(restored, dict):
        sub = template if isinstance(template, dict) else {}
        return {k: _like(sub.get(k), v) for k, v in restored.items()}
    if isinstance(restored, (list, tuple)):
        sub = template if isinstance(template, (list, tuple)) and len(template) == len(restored) \
            else [None] * len(restored)
        return type(restored)(_like(t, v) for t, v in zip(sub, restored))
    if isinstance(restored, torch.Tensor) and isinstance(template, torch.Tensor):
        return restored.to(template.device)
    return restored


class CheckpointManager:
    """save(step, state), restore_latest(template), keeping the newest
    `max_to_keep` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        makedir(directory)
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _steps_on_disk(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def all_steps(self) -> List[int]:
        """The steps on disk, oldest first, once a pending write is done."""
        self.wait()
        return self._steps_on_disk()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, metadata: Optional[dict] = None) -> None:
        latest = self.latest_step()  # waits for the save before
        if latest is not None and step < latest:
            return  # stale re-save from a resumed run; keep the newer step
        if latest is not None and step == latest:
            # the end-of-run save at the last cadence step: a new step, so
            # that the only checkpoint is never deleted before its rewrite
            step = latest + 1
        payload = {"state": _to_host(state), "metadata": metadata}
        if self.async_save:
            self._thread = threading.Thread(target=self._write_guarded, args=(step, payload))
            self._thread.start()
        else:
            self._write(step, payload)

    def _write_guarded(self, step: int, payload: dict) -> None:
        try:
            self._write(step, payload)
        except BaseException as ex:  # noqa: BLE001 - raised again by wait()
            self._error = ex

    def _write(self, step: int, payload: dict) -> None:
        path = self._path(step)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        steps = self._steps_on_disk()
        for old in steps[: max(0, len(steps) - self.max_to_keep)]:
            os.remove(self._path(old))

    def restore_latest(self, template: Any):
        """The state saved at the latest step, placed as `template`'s
        leaves are; None when the directory holds no step."""
        step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return _like(template, payload["state"])

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()
