"""Small shared utilities (counterpart of ``genmmrec_tpu/utils/misc.py``)."""

from __future__ import annotations

import datetime


def get_local_time() -> str:
    return datetime.datetime.now().strftime("%b-%d-%Y-%H-%M-%S")
