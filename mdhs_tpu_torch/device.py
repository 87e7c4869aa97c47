"""Device resolution for the port's entry points, and constants made once on a device."""

from __future__ import annotations

from typing import Callable

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for and absent.

    There is no silent move to the CPU: a caller that asks for ``"cuda"`` on
    a machine without a card gets an error.

    For a CUDA device this also pins the float32 math to full precision:
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) and
    ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's default is True,
    which runs float32 convolutions in TF32). The float32 path is the parity
    path against the JAX reference, which runs its matmuls at "highest"
    precision; the bf16 serving path is unaffected by either flag.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected 'cpu' or 'cuda'")
    return dev


def add_device_argument(parser) -> None:
    """The entry points' ``--device`` flag."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises where there is no card) or cpu")


def device_constant(cache: dict, key, make: Callable):
    """``cache[key]``, made by ``make()`` on its first call: a constant made from
    host data on every call would be a synchronous host-to-device copy on the
    card. ``make`` runs outside inference mode, so the tensors are usable in
    training too. While ``torch.export`` traces, a constant kept from an eager
    call is read as a constant of the program, and one made inside the trace is
    not kept, so no traced tensor reaches a later eager call."""
    value = cache.get(key)
    if value is None:
        with torch.inference_mode(False):
            value = make()
        if not torch.compiler.is_exporting():
            cache[key] = value
    return value
