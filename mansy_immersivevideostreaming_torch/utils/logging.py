"""Console tee, plain-ASCII table rendering and the TensorBoard writer
(copies of the JAX package's ``ConsoleLogger`` and ``ascii_table``,
reference ``viewport_prediction/utils/console_logger.py:1-12``, and the
optional scalar writer of its ``run_mansy`` and ``run_simple_rl``)."""

from __future__ import annotations

from typing import Iterable, List, Sequence


class ConsoleLogger:
    """Tee writes to several streams (stdout + log files)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, data):
        # flush eagerly: the CLIs never close the tee'd log file, so buffered
        # writes would otherwise be lost to concurrent readers (and to a crash)
        for s in self.streams:
            s.write(data)
            s.flush()

    def flush(self):
        for s in self.streams:
            s.flush()


def ascii_table(field_names: Sequence[str], rows: Iterable[Sequence]) -> str:
    """PrettyTable-style box table."""
    rows = [[str(c) for c in r] for r in rows]
    names = [str(n) for n in field_names]
    widths = [len(n) for n in names]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out: List[str] = [sep]
    out.append("|" + "|".join(f" {n:^{w}} " for n, w in zip(names, widths)) + "|")
    out.append(sep)
    for r in rows:
        out.append("|" + "|".join(f" {c:^{w}} " for c, w in zip(r, widths)) + "|")
    out.append(sep)
    return "\n".join(out)


def tb_writer(log_dir: str):
    """A TensorBoard scalar writer into ``log_dir`` (``tensorboardX``'s
    ``SummaryWriter``: ``add_scalar(tag, value, step)``, ``close()``), or
    None where the package is missing, as the JAX CLIs' writer is None
    where ``torch.utils.tensorboard`` does not import.  Not
    ``torch.utils.tensorboard``: importing it can pull JAX and TensorFlow
    into the process."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)
