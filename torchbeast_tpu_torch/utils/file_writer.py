"""Experiment logger (a copy of torchbeast_tpu/utils/file_writer.py): `{savedir}/{xpid}/` with out.log, logs.csv, fields.csv,
meta.json and a `latest` symlink.

Capability parity with the reference FileWriter
(upstream torchbeast, torchbeast/core/file_writer.py:100-211): dynamic CSV schema
(new stat keys append a fresh fieldnames row to fields.csv and widen
logs.csv), append-resume continuing `_tick` from the last row, and metadata
capture (git SHA/branch/dirty, SLURM env, environ) in meta.json. Implemented
without gitpython (subprocess git) and with stdlib csv/json only.
"""

import csv
import datetime
import json
import logging
import os
import subprocess
import time
from typing import Dict, Optional


def gather_metadata() -> Dict:
    meta = {
        "date_start": datetime.datetime.now().isoformat(),
        "date_end": None,
        "successful": False,
    }
    try:
        def git(*args):
            return subprocess.run(
                ["git", *args], capture_output=True, text=True, timeout=5
            ).stdout.strip()

        sha = git("rev-parse", "HEAD")
        if sha:
            meta["git"] = {
                "commit": sha,
                "branch": git("rev-parse", "--abbrev-ref", "HEAD"),
                "is_dirty": bool(git("status", "--porcelain")),
            }
    except Exception:
        pass
    slurm = {
        k.replace("SLURM_", "").lower(): v
        for k, v in os.environ.items()
        if k.startswith("SLURM_")
    }
    if slurm:
        meta["slurm"] = slurm
    # Allowlist, not a full environ dump: meta.json lands in every
    # experiment dir and a blanket copy would spill tokens/credentials.
    # Keep only the vars that explain how the run behaved.
    allowed_prefixes = ("SLURM_", "CUDA_", "TORCH_", "NCCL_")
    allowed_exact = {"HOSTNAME", "USER", "CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS"}
    meta["env"] = {
        k: v
        for k, v in os.environ.items()
        if k.startswith(allowed_prefixes) or k in allowed_exact
    }
    return meta


class FileWriter:
    def __init__(
        self,
        xpid: Optional[str] = None,
        xp_args: Optional[dict] = None,
        rootdir: str = "~/logs/torchbeast_tpu_torch",
        symlink_to_latest: bool = True,
    ):
        if not xpid:
            xpid = f"{os.getpid()}_{int(time.time())}"
        self.xpid = xpid
        self._tick = 0

        self.metadata = gather_metadata()
        # Copy because the caller may keep mutating its flags dict (the
        # reference serializes vars(flags) the same way, file_writer.py:88).
        self.metadata["args"] = dict(xp_args or {})
        self.metadata["xpid"] = self.xpid

        rootdir = os.path.expandvars(os.path.expanduser(rootdir))
        self.basepath = os.path.join(rootdir, self.xpid)
        os.makedirs(self.basepath, exist_ok=True)

        if symlink_to_latest:
            symlink = os.path.join(rootdir, "latest")
            try:
                if os.path.islink(symlink):
                    os.remove(symlink)
                if not os.path.exists(symlink):
                    os.symlink(self.basepath, symlink)
            except OSError:
                pass

        self.paths = {
            "msg": os.path.join(self.basepath, "out.log"),
            "logs": os.path.join(self.basepath, "logs.csv"),
            "fields": os.path.join(self.basepath, "fields.csv"),
            "meta": os.path.join(self.basepath, "meta.json"),
            # Reserved for JSON-lines telemetry snapshots (the JAX
            # package's drivers write them; the port emits none yet).
            "telemetry": os.path.join(self.basepath, "telemetry.jsonl"),
        }

        self._logger = logging.getLogger(f"filewriter.{xpid}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        if not self._logger.handlers:
            fmt = logging.Formatter("%(message)s")
            fhandle = logging.FileHandler(self.paths["msg"])
            fhandle.setFormatter(fmt)
            self._logger.addHandler(fhandle)

        self._save_metadata()

        self.fieldnames = ["_tick", "_time"]
        if os.path.exists(self.paths["logs"]):
            # Resume: recover schema (first line) and tick counter (last
            # line). Streamed — head + tail only, never the whole file
            # (multi-GB logs on long runs).
            with open(self.paths["logs"], newline="") as f:
                first = next(csv.reader(f), None)
            if first:
                self.fieldnames = first
                last = self._tail_line(self.paths["logs"])
                try:
                    self._tick = int(last.split(",", 1)[0]) + 1
                except (ValueError, AttributeError):
                    pass  # header-only file, or non-numeric first cell

    def log(self, to_log: Dict, tick: Optional[int] = None, verbose: bool = False):
        if tick is not None:
            raise NotImplementedError("custom ticks not supported")
        to_log = dict(to_log)
        to_log["_tick"] = self._tick
        self._tick += 1
        to_log["_time"] = time.time()

        old_len = len(self.fieldnames)
        for k in to_log:
            if k not in self.fieldnames:
                self.fieldnames.append(k)
        if old_len != len(self.fieldnames) or not os.path.exists(
            self.paths["logs"]
        ):
            self._write_fields_row()

        if verbose:
            self._logger.info(
                "LOG | %s",
                ", ".join(f"{k}: {v}" for k, v in sorted(to_log.items())),
            )

        with open(self.paths["logs"], "a") as f:
            writer = csv.DictWriter(f, fieldnames=self.fieldnames)
            if f.tell() == 0:
                writer.writeheader()
            writer.writerow(to_log)

    def _write_fields_row(self):
        # fields.csv accumulates one row per schema version (reference
        # file_writer.py:183-189).
        with open(self.paths["fields"], "a") as f:
            csv.writer(f).writerow(self.fieldnames)
        # Patch the logs.csv header to the widened schema. Streamed line-
        # by-line through a temp file + atomic replace: bounded memory on
        # arbitrarily long runs, and a crash mid-patch can never corrupt
        # the log. Fieldnames only ever grow, so this runs at most once
        # per distinct key the run ever logs — not per log() call.
        if os.path.exists(self.paths["logs"]):
            tmp = self.paths["logs"] + ".tmp"
            with open(self.paths["logs"]) as src, open(tmp, "w") as dst:
                csv.writer(dst).writerow(self.fieldnames)
                next(src, None)  # drop the old (narrower) header line
                for line in src:
                    dst.write(line)
            os.replace(tmp, self.paths["logs"])

    @staticmethod
    def _tail_line(path, chunk: int = 65536):
        """Last non-empty line of a text file, reading only its tail."""
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - chunk))
            tail = f.read().decode("utf-8", errors="replace")
        lines = [ln for ln in tail.splitlines() if ln.strip()]
        return lines[-1] if lines else None

    def _save_metadata(self):
        with open(self.paths["meta"], "w") as f:
            json.dump(self.metadata, f, indent=2, default=str)

    def close(self, successful: bool = True):
        self.metadata["date_end"] = datetime.datetime.now().isoformat()
        self.metadata["successful"] = successful
        self._save_metadata()
        # Detach and close the out.log FileHandler: the logger object
        # outlives this writer (logging keeps loggers in a global
        # registry keyed by name), so leaving the handler attached leaks
        # one open fd per FileWriter lifetime — long test sessions and
        # multi-writer runs accumulate them (and a same-xpid successor's
        # handler guard would see stale handlers and never attach).
        for handler in list(self._logger.handlers):
            self._logger.removeHandler(handler)
            handler.close()
