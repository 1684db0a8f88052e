"""Comms logger.

Port of ``deepspeed_tpu/utils/comms_logging.py`` (reference
``deepspeed/utils/comms_logging.py``: ``CommsLogger`` :61, ``calc_bw_log``
:28). The port's collectives run eagerly, one call a record: the summary
counts calls and bytes per (op, group, message size).
"""

import inspect

from .logging import logger


def get_caller_func(frame=3):
    """Name of the function ``frame`` frames above this one (stack[0] is
    this function, stack[1] its caller)."""
    stack = inspect.stack(context=0)
    try:
        return stack[frame].function if frame < len(stack) else "<toplevel>"
    finally:
        del stack


def convert_size(nbytes):
    """Human-readable byte count (binary units)."""
    value = float(nbytes)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if value < 1024 or unit == "TB":
            return f"{value:g} {unit}" if unit == "B" else f"{round(value, 2)} {unit}"
        value /= 1024
    return f"{nbytes} B"


# per collective, (wire-traffic multiplier, bus-traffic multiplier) for a
# group of n (ring accounting, as the JAX package's table)
_TRAFFIC = {
    "all_reduce": (lambda n: (2.0, 2.0 * (n - 1) / n)),
    "inference_all_reduce": (lambda n: (2.0, 2.0 * (n - 1) / n)),
    "all_gather": (lambda n: (float(n), n - 1.0)),
    "all_gather_into_tensor": (lambda n: (float(n), n - 1.0)),
    "reduce_scatter": (lambda n: (float(n), n - 1.0)),
    "reduce_scatter_tensor": (lambda n: (float(n), n - 1.0)),
    "all_to_all": (lambda n: (1.0, (n - 1) / n)),
    "all_to_all_single": (lambda n: (1.0, (n - 1) / n)),
}


def calc_bw_log(comm_op, size, duration, n):
    """(algorithmic, bus) bandwidth in Gbit/s for one timed collective of
    ``size`` bytes over an ``n``-member group."""
    seconds = max(duration, 1e-9)
    algo_mult, bus_mult = _TRAFFIC.get(comm_op, lambda n: (1.0, 1.0))(max(n, 1))
    to_gbits = 8.0 / seconds * 1e-9
    return size * algo_mult * to_gbits, size * bus_mult * to_gbits


class CommsLogger:

    def __init__(self, comms_config=None):
        if comms_config is not None:
            self.enabled = comms_config.enabled
            self.prof_all = comms_config.prof_all
            self.debug = comms_config.debug
            self.prof_ops = comms_config.prof_ops or []
            self.verbose = comms_config.verbose
        else:
            self.enabled = False
            self.prof_all = True
            self.debug = False
            self.prof_ops = []
            self.verbose = False
        # {op_name: {group: {size: count}}}
        self.comms_dict = {}

    def append(self, op_name, group, size):
        if self.prof_ops and op_name not in self.prof_ops:
            return
        per_op = self.comms_dict.setdefault(op_name, {})
        per_group = per_op.setdefault(group, {})
        per_group[size] = per_group.get(size, 0) + 1
        if self.verbose:
            logger.info(f"comm op: {op_name} | group: {group} | msg size: {convert_size(size)}")

    def log_all(self, print_log=True):
        lines = [f"{'Comm. Op':20s} {'Group':30s} {'Message Size':15s} {'Calls':12s} {'Total Bytes':15s}"]
        for op_name, groups in self.comms_dict.items():
            for group, sizes in groups.items():
                for size, count in sorted(sizes.items()):
                    lines.append(f"{op_name:20s} {group:30s} {convert_size(size):15s} {count:<12d} "
                                 f"{convert_size(size * count):15s}")
        summary = "\n".join(lines)
        if print_log:
            logger.info("Communication summary\n" + summary)
        return summary
