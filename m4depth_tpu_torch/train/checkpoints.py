"""Checkpointing: rolling training checkpoints and the best-K backups.
Counterpart of ``m4depth_tpu/train/checkpoints.py``, on ``torch.save``.

  * ``TrainCheckpointManager``: restore the latest on start, save per
    epoch, keep the last ``max_keep``. A checkpoint is one file,
    ``<epoch>.pt``, holding a ``TrainState``'s state (the model's weights,
    the Adam state with its per-parameter step counts, the schedule's
    count) and the epoch, all on the CPU.
  * ``BestCheckpointManager``: keep the top-N weight sets by majority vote
    over 7 validation metrics (4 lower-is-better, 3 higher-is-better) with
    a CSV ledger, ``validation_perfs.csv``, read and written with ``csv``.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional

import torch

from m4depth_tpu_torch.train.step import TrainState

LOWER_IS_BETTER = ("abs_rel", "sq_rel", "rmse", "rmsel")
HIGHER_IS_BETTER = ("a1", "a2", "a3")
LEDGER_COLUMNS = LOWER_IS_BETTER + HIGHER_IS_BETTER + ("ckpt_name",)


def save_state(path: str, state: TrainState, epoch: int) -> None:
    """Write ``state`` and ``epoch`` to ``path`` (through a temporary file,
    so an interrupted save leaves no partial checkpoint)."""
    tmp = path + ".tmp"
    torch.save({**state.state_dict(), "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)


def load_state(path: str, state: TrainState) -> TrainState:
    """Load the checkpoint at ``path`` into ``state`` (in place)."""
    return state.load_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))


class TrainCheckpointManager:
    """Rolling checkpoint store for the train state."""

    def __init__(self, directory: str, max_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def epochs(self) -> List[int]:
        return sorted(int(m.group(1)) for m in (
            re.fullmatch(r"(\d+)\.pt", n) for n in os.listdir(self.directory))
            if m)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    @property
    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    @property
    def resume_epoch(self) -> int:
        """First epoch to run."""
        latest = self.latest_epoch
        return 0 if latest is None else latest + 1

    def save(self, epoch: int, state: TrainState) -> None:
        save_state(self.path(epoch), state, epoch)
        for old in self.epochs()[:-self.max_keep]:
            os.remove(self.path(old))

    def restore_latest(self, state: TrainState) -> TrainState:
        """Load the latest checkpoint into ``state``; unchanged if none."""
        latest = self.latest_epoch
        return state if latest is None else load_state(self.path(latest),
                                                       state)


def _read_ledger(path: str) -> List[Dict]:
    with open(path, newline="") as f:
        return [{k: (v if k == "ckpt_name" else float(v))
                 for k, v in row.items()} for row in csv.DictReader(f)]


def _write_ledger(path: str, rows: List[Dict]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=LEDGER_COLUMNS)
        writer.writeheader()
        for row in rows:
            writer.writerow({k: (repr(float(v)) if k != "ckpt_name" else v)
                             for k, v in row.items()})
    os.replace(tmp, path)


class BestCheckpointManager:
    """Top-N backup by majority vote across validation metrics.

    A candidate replaces an existing entry when strictly more than half of
    the 7 metrics improve (>3 of 7, as the reference counts it).
    """

    def __init__(self, train_dir: str, best_dir: str, keep_top_n: int = 1):
        self.train_dir = os.path.abspath(train_dir)
        self.best_dir = os.path.abspath(best_dir)
        self.keep_top_n = keep_top_n
        os.makedirs(self.best_dir, exist_ok=True)
        self.ledger_path = os.path.join(self.best_dir, "validation_perfs.csv")

    @staticmethod
    def _wins(candidate: Dict[str, float], incumbent: Dict[str, float]) -> int:
        n = 0
        for m in LOWER_IS_BETTER:
            n += int(incumbent[m] > candidate[m])
        for m in HIGHER_IS_BETTER:
            n += int(incumbent[m] < candidate[m])
        return n

    def _backup(self, epoch: int, state: TrainState) -> str:
        name = f"ckpt-{epoch:04d}"
        save_state(os.path.join(self.best_dir, name + ".pt"), state, epoch)
        return name

    def _remove(self, name: str) -> None:
        path = os.path.join(self.best_dir, f"{name}.pt")
        if os.path.exists(path):
            os.remove(path)

    def update(self, epoch: int, perfs: Dict[str, float],
               state: TrainState) -> bool:
        """Consider (epoch, perfs); back up the state if it makes the top-N.

        perfs keys: abs_rel, sq_rel, rmse, rmsel, a1, a2, a3.
        Returns True if a backup was made.
        """
        row = {k: float(perfs[k]) for k in LOWER_IS_BETTER + HIGHER_IS_BETTER}
        if not os.path.isfile(self.ledger_path):
            row["ckpt_name"] = self._backup(epoch, state)
            _write_ledger(self.ledger_path, [row])
            return True

        ledger = _read_ledger(self.ledger_path)
        name = f"ckpt-{epoch:04d}"
        dup = [i for i, r in enumerate(ledger) if r["ckpt_name"] == name]
        if dup:
            # Same-epoch re-validation: backups are keyed by epoch, so a
            # second row would alias the first's file. The row is replaced
            # (the overwritten backup now holds this state, so its metrics
            # must describe it), and a replacement that the row it
            # overwrites beats by the vote is reported, not kept silent.
            old = ledger[dup[0]]
            if self._wins(old, row) > 3:
                print(f"WARNING: re-validation of epoch {epoch} replaces "
                      f"its best-checkpoint row with metrics that lose the "
                      f"majority vote against the row it overwrites "
                      f"({old} -> {row})", flush=True)
            row["ckpt_name"] = self._backup(epoch, state)
            ledger[dup[0]] = row
            _write_ledger(self.ledger_path, ledger)
            return True
        if len(ledger) < self.keep_top_n:
            row["ckpt_name"] = self._backup(epoch, state)
            _write_ledger(self.ledger_path, ledger + [row])
            return True

        for i, incumbent in enumerate(ledger):
            if self._wins(row, incumbent) > 3:
                row["ckpt_name"] = self._backup(epoch, state)
                ledger.append(row)
                if len(ledger) > self.keep_top_n:
                    self._remove(ledger[i]["ckpt_name"])
                    del ledger[i]
                _write_ledger(self.ledger_path, ledger)
                return True
        return False

    def best_checkpoint_name(self) -> Optional[str]:
        """The ledger entry that majority-vote-beats the most others.

        Entry and eviction use the >3-of-7 vote; selection uses the same
        vote as a round-robin tournament, so ``restore_best`` never returns
        a checkpoint the vote would reject. Ties go to the newer entry.
        """
        if not os.path.isfile(self.ledger_path):
            return None
        ledger = _read_ledger(self.ledger_path)
        if not ledger:
            return None
        n = len(ledger)
        best_idx, best_wins = n - 1, -1
        for i in range(n):
            wins = sum(self._wins(ledger[i], ledger[j]) > 3
                       for j in range(n) if j != i)
            if wins >= best_wins:  # >= : newer entry wins ties
                best_idx, best_wins = i, wins
        return ledger[best_idx]["ckpt_name"]

    def restore_best(self, state: TrainState) -> Optional[TrainState]:
        """Load the ledger's winner into ``state``; None if there is none."""
        name = self.best_checkpoint_name()
        if name is None:
            return None
        return load_state(os.path.join(self.best_dir, f"{name}.pt"), state)


def promote_best_to_train(best_dir: str, train_dir: str, state: TrainState,
                          keep_top_n: int = 1) -> Optional[int]:
    """Re-save the ledger-winning best checkpoint under the train manager's
    epoch naming, so a later run (finetune) resumes from it.

    A plain copy of the best directory would not do: its files are named
    ``ckpt-NNNN.pt`` while ``TrainCheckpointManager`` looks for
    ``<epoch>.pt``, so a finetune would silently start from scratch.

    Returns the promoted epoch, or ``None`` when there is no best checkpoint.
    """
    best = BestCheckpointManager(train_dir, best_dir, keep_top_n=keep_top_n)
    name = best.best_checkpoint_name()
    if name is None:
        return None
    best.restore_best(state)
    epoch = int(str(name).rsplit("-", 1)[-1])
    TrainCheckpointManager(train_dir).save(epoch, state)
    return epoch
