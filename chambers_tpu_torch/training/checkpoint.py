"""Checkpoints with resume (port of ``chambers_tpu/training/checkpoint.py``).

The JAX package writes Orbax directories; the port writes one
``torch.save`` file a step, ``<directory>/<step>.pt``, to a temporary name
that is then ``os.replace``d, so a kill mid-save never leaves a half
checkpoint. Saves are synchronous (``wait`` has nothing to wait for). The
JAX package's Orbax directories are not read (that needs tensorstore); a
JAX model reaches the port through its ``Model.save_weights`` file
(``chambers_tpu_torch.models.Model.load_weights``).

A checkpoint of a :class:`~chambers_tpu_torch.training.Trainer` holds its
:class:`~chambers_tpu_torch.training.TrainState`: parameters and buffers,
optimizer state, EMA shadow, gradient accumulator, step and generator
state — everything that sets the next step, so a resumed run is
bit-equal to an uninterrupted one.

Under a mesh (``Trainer(mesh=)``, one process a device) the checkpoint
holds whole tensors, as Orbax's of global arrays do: every rank gathers
the Trainer's :meth:`~chambers_tpu_torch.training.Trainer.global_state`,
the mesh's first rank writes it (the temporary name, then ``os.replace``)
while the others wait at a barrier, and on restore every rank reads the
same file and the Trainer keeps its shard. The file is the one a run
without a mesh writes, so a checkpoint moves between meshes and to and
from a run without one. Every rank must call ``save``.
"""

from __future__ import annotations

import os
import re
import signal
from typing import Any, Optional

import torch

from chambers_tpu_torch.callbacks import Callback
from chambers_tpu_torch.parallel.sharding import write_once

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Saves objects of tensors keyed by step and keeps the newest
    ``max_to_keep``; a save happens when ``step`` is a multiple of
    ``save_interval_steps`` (or is forced). With a ``mesh`` (a
    ``DeviceMesh`` over the processes of the run) every process calls
    ``save`` with the same whole-tensor state, the mesh's first rank
    writes it, and all of them return once it is on disk.

    Example::

        ckpt = CheckpointManager("experiments/run1/ckpt", max_to_keep=3)
        state = ckpt.restore_latest()
        if state is not None:
            trainer.state = state
        ...
        ckpt.save(trainer.state.step, trainer.state.as_dict())
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, mesh=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        self._mesh = mesh

    def _path(self, step):
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` at ``step``; returns whether it was written."""
        step = int(step)
        latest = self.latest_step()
        if not force and (step % self.save_interval_steps
                          or (latest is not None and step <= latest)):
            return False

        def write():
            tmp = self._path(step) + f".tmp{os.getpid()}"
            torch.save(state, tmp)
            os.replace(tmp, self._path(step))
            steps = self.all_steps()
            if self.max_to_keep is not None:
                for old in steps[:-self.max_to_keep]:
                    os.remove(self._path(old))

        # under a mesh: every rank has decided before the file changes,
        # and none goes on before it is there
        write_once(self._mesh, write)
        return True

    def restore(self, step: int, target: Any = None) -> Any:
        """The object saved at ``step``, its tensors on the CPU (or, given a
        ``target`` with a ``device``, on that device)."""
        device = getattr(target, "device", "cpu")
        return torch.load(self._path(step), map_location=device,
                          weights_only=False)

    def restore_latest(self, target: Any = None) -> Optional[Any]:
        """The newest checkpoint, or None if there is none."""
        step = self.latest_step()
        return None if step is None else self.restore(step, target)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def wait(self):
        """Saves are synchronous: nothing is pending."""

    def close(self):
        """Nothing to release."""


class CheckpointCallback(Callback):
    """Trainer callback: checkpoint the full train state every epoch
    (:class:`chambers_tpu_torch.callbacks.ModelCheckpoint` writes weights
    only). Under the Trainer's mesh the state is its whole-tensor
    ``global_state``, and every rank runs the callback."""

    def __init__(self, directory: str, trainer, max_to_keep: int = 3):
        self.manager = CheckpointManager(directory, max_to_keep=max_to_keep,
                                         mesh=getattr(trainer, "mesh", None))
        self.trainer = trainer

    def _save(self, force=False):
        return self.manager.save(self.trainer.step,
                                 self.trainer.global_state().as_dict(),
                                 force=force)

    def on_epoch_end(self, epoch, logs=None):
        self._save()

    def on_train_end(self, logs=None):
        if self.manager.latest_step() != self.trainer.step:
            self._save(force=True)
        self.manager.wait()

    def restore_into(self, trainer) -> bool:
        """Restore-on-start: load the latest checkpoint into ``trainer``.
        A checkpoint without an EMA shadow restored into an EMA Trainer
        seeds the shadow from the restored parameters; a shadow the
        Trainer does not keep is dropped. Under a mesh each rank keeps its
        shard of the whole tensors."""
        restored = self.manager.restore_latest(trainer)
        if restored is None:
            return False
        trainer.state = restored
        return True


class PreemptionCheckpoint(CheckpointCallback):
    """Save on SIGTERM and stop cleanly.

    For the length of ``Trainer.fit`` a handler records a monitored
    signal; at the next batch boundary (never inside the handler) the
    callback saves the full train state, sets ``stop_training`` so ``fit``
    returns, and :attr:`preempted` reads True. Under ``steps_per_execution``
    the boundary is the window's end. ``save_every_steps`` adds a
    mid-epoch cadence. The previous handlers come back at train end.
    """

    def __init__(self, directory: str, trainer, max_to_keep: int = 3,
                 save_every_steps: Optional[int] = None,
                 signals=(signal.SIGTERM,)):
        super().__init__(directory, trainer, max_to_keep=max_to_keep)
        self.save_every_steps = save_every_steps
        self.signals = tuple(signals)
        self._received: Optional[int] = None
        self._previous: dict = {}
        self._preempted = False

    def _handler(self, signum, frame):
        # only record the fact; the save happens at a batch boundary
        self._received = signum

    def on_train_begin(self, logs=None):
        self._received = None
        self._preempted = False
        self._previous = {s: signal.signal(s, self._handler)
                          for s in self.signals}

    def on_train_end(self, logs=None):
        for s, prev in self._previous.items():
            signal.signal(s, prev if callable(prev) or prev in (
                signal.SIG_IGN, signal.SIG_DFL) else signal.SIG_DFL)
        self._previous = {}
        super().on_train_end(logs)

    def on_train_batch_end(self, batch, logs=None):
        step = self.trainer.step
        if self._received is not None:
            self._save(force=True)
            self.trainer.stop_training = True
            self._preempted = True
            print(f"PreemptionCheckpoint: signal "
                  f"{signal.Signals(self._received).name} -> saved step "
                  f"{step}, stopping")
            self._received = None
        elif self.save_every_steps and step and (
                step % self.save_every_steps == 0):
            self._save()

    @property
    def preempted(self) -> bool:
        """Whether a monitored signal arrived (and triggered the save), not
        merely that training stopped."""
        return self._preempted
