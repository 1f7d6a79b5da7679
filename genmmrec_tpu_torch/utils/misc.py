"""Small shared utilities (counterpart of ``genmmrec_tpu/utils/misc.py``)."""

from __future__ import annotations

import datetime


def get_local_time() -> str:
    return datetime.datetime.now().strftime("%b-%d-%Y-%H-%M-%S")


def early_stopping(value, best, cur_step, max_step, bigger=True):
    """Validation-based early stopping: ``(best, cur_step, stop_flag,
    update_flag)``. A strict improvement resets the counter; ``stop_flag``
    rises once ``cur_step`` exceeds ``max_step``."""
    stop_flag, update_flag = False, False
    improved = (value > best) if bigger else (value < best)
    if improved:
        best, cur_step, update_flag = value, 0, True
    else:
        cur_step += 1
        stop_flag = cur_step > max_step
    return best, cur_step, stop_flag, update_flag


def dict2str(result_dict) -> str:
    return "    ".join(f"{k}: {v:.04f}" for k, v in result_dict.items()) + "    "
