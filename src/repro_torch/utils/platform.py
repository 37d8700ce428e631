"""Device selection shared by the CLIs, the worker pool and the server.

The counterpart of ``repro.utils.platform``. The reference's module
configures JAX backends: ``set_platform`` selects a JAX platform and
forces fake host devices through ``XLA_FLAGS`` before the backend starts,
and ``host_device_env`` builds a subprocess environment carrying that
flag. Those have no PyTorch meaning (a torch process sees its cards as
they are, and CPU "devices" need no flag), so the port keeps only:

- ``worker_devices(n, device=)``: the devices a per-device worker pool
  runs on;
- ``add_platform_args(parser)`` / ``apply_platform_args(args)``: the
  shared ``--device {cuda,cpu}`` flag, in place of ``--platform`` /
  ``--host-devices``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.utils.device import indexed


def worker_devices(n: int | None = None, *, device=None) -> tuple:
    """The devices a per-device worker pool should run on.

    Parameters
    ----------
    n : int or None
        Number of devices wanted (the pool's worker count). ``None``
        returns every card (one CPU device for ``device="cpu"``).
    device : str or torch.device or None
        ``None`` / ``"cuda"``: the first ``n`` cards, in index order (so
        worker *i* always pins the same card). ``"cpu"``: ``n`` times
        the CPU (the plain path; workers share it).

    Returns
    -------
    tuple of torch.device

    Raises
    ------
    ValueError
        If ``n < 1``, or fewer than ``n`` cards exist (with the remedy:
        fewer workers, or explicit ``devices=`` repeating a card).
    RuntimeError
        If cards are asked for and there is none.
    """
    dev = indexed(device)
    if dev.type == "cpu":
        count = 1 if n is None else int(n)
        if count < 1:
            raise ValueError(f"need at least 1 worker device, got n={n}")
        return (dev,) * count
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    if n is None:
        return devs
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least 1 worker device, got n={n}")
    if n > len(devs):
        raise ValueError(
            f"{n} worker devices requested but only {len(devs)} card(s) "
            f"exist — ask for at most {len(devs)} workers, or pass "
            "explicit devices= (a card may repeat: its workers then share "
            "it, each on a stream of its own)")
    return devs[:n]


def add_platform_args(parser: argparse.ArgumentParser) -> None:
    """Install the shared ``--device`` flag."""
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="run on the card (default; raises without "
                             "one) or on the CPU's plain path")


def apply_platform_args(args: argparse.Namespace) -> torch.device:
    """Resolve the ``--device`` flag: the device the CLI runs on (a card
    asked for on a machine without one raises)."""
    return indexed(getattr(args, "device", None))
