"""Logging for lightgbm_tpu_torch.

Port of the reference logger (include/LightGBM/utils/log.h:88-178):
levels Debug/Info/Warning/Fatal, a pluggable callback, and ``Fatal`` raising an
exception instead of aborting the process.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional


class LightGBMError(RuntimeError):
    """Error raised by the framework (reference: Log::Fatal -> std::runtime_error)."""


# Verbosity levels mirror the reference config `verbosity`:
#   <0 = Fatal only, 0 = Error/Warning, 1 = Info, >1 = Debug
_LEVEL_FATAL = -1
_LEVEL_WARNING = 0
_LEVEL_INFO = 1
_LEVEL_DEBUG = 2

_verbosity: int = 1
_callback: Optional[Callable[[str], None]] = None


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def get_verbosity() -> int:
    return _verbosity


def register_callback(cb: Optional[Callable[[str], None]]) -> None:
    """Reference: LGBM_RegisterLogCallback / Log::ResetCallBack."""
    global _callback
    _callback = cb


def register_logger(logger, info_method_name: str = "info",
                    warning_method_name: str = "warning") -> None:
    """Route all framework output through a `logging.Logger`-like object
    (reference: lightgbm.register_logger, basic.py:134-180)."""
    if not callable(getattr(logger, info_method_name, None)) or \
            not callable(getattr(logger, warning_method_name, None)):
        raise TypeError(
            f"logger must provide callable {info_method_name}() and "
            f"{warning_method_name}() methods")
    info_fn = getattr(logger, info_method_name)
    warn_fn = getattr(logger, warning_method_name)

    def _cb(msg: str) -> None:
        text = msg.rstrip("\n")
        if "[Warning]" in text or "[Fatal]" in text:
            warn_fn(text)
        else:
            info_fn(text)

    register_callback(_cb)


def _emit(msg: str) -> None:
    if _callback is not None:
        _callback(msg + "\n")
    else:
        print(msg, file=sys.stderr, flush=True)


def debug(msg: str, *args) -> None:
    if _verbosity >= _LEVEL_DEBUG:
        _emit("[LightGBM] [Debug] " + (msg % args if args else msg))


def info(msg: str, *args) -> None:
    if _verbosity >= _LEVEL_INFO:
        _emit("[LightGBM] [Info] " + (msg % args if args else msg))


def warning(msg: str, *args) -> None:
    if _verbosity >= _LEVEL_WARNING:
        _emit("[LightGBM] [Warning] " + (msg % args if args else msg))


def fatal(msg: str, *args) -> None:
    text = msg % args if args else msg
    _emit("[LightGBM] [Fatal] " + text)
    raise LightGBMError(text)
