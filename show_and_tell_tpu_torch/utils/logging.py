"""Dual file+console logging (reference utils.py:9-20).

File handler at DEBUG, console at INFO, same as the reference's
``setup_logging`` — but without mutating the root logger config globally more
than once (the reference calls ``logging.basicConfig`` which is a no-op on
re-entry; we handle repeated setup explicitly for tests).
"""

from __future__ import annotations

import logging

_CONFIGURED = False


def setup_logging(log_file: str = "log.txt", mode: str = "w") -> logging.Logger:
    """``mode="a"`` is for resumed runs (``--start_from``): an epoch-chain
    respawn into the same experiment dir must extend the run log, not
    truncate the previous processes' epochs out of it."""
    global _CONFIGURED
    root = logging.getLogger()
    if _CONFIGURED:
        return root
    # Root stays at INFO so that third-party libraries' DEBUG records don't
    # flood the run log; our own package logs DEBUG to the file.
    root.setLevel(logging.INFO)
    logging.getLogger("show_and_tell_tpu_torch").setLevel(logging.DEBUG)

    fh = logging.FileHandler(log_file, mode=mode)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(
        logging.Formatter(
            "%(asctime)s - %(levelname)s - %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
        )
    )
    root.addHandler(fh)

    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(message)s"))
    root.addHandler(console)

    _CONFIGURED = True
    return root
