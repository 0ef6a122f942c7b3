"""Structured spans on Python ``logging`` (``norma_tpu/tracing.py:30-130``).

  - ``span`` / ``instrument`` — timed spans with user fields
  - ``decode_telemetry`` — the reference's per-decode trace fields
    (at_temp, logprob, no_speech_prob)

Device profiling helpers are not ported yet.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import logging
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("norma_tpu_torch")


@contextlib.contextmanager
def span(name: str, level: int = logging.DEBUG, **fields: Any):
    """A timed, structured span: logs entry fields and exit duration.
    Errors are logged at ERROR level with the elapsed time."""
    t0 = time.perf_counter()
    logger.log(level, "%s enter %s", name, fields if fields else "")
    try:
        yield fields
    except Exception as e:
        logger.log(logging.ERROR, "%s error after %.3fms: %r",
                   name, (time.perf_counter() - t0) * 1e3, e)
        raise
    else:
        logger.log(level, "%s exit %.3fms", name, (time.perf_counter() - t0) * 1e3)


def instrument(
    _fn=None,
    *,
    name: Optional[str] = None,
    level: int = logging.DEBUG,
    fields: Optional[Dict[str, Any]] = None,
):
    """Decorator wrapping a call in a :func:`span`.

    ``fields`` maps a span-field name to an extractor over the call's bound
    arguments; extraction is skipped when the logger isn't enabled for
    ``level``.  Errors are logged at every level.
    """

    def deco(fn):
        span_name = name or fn.__qualname__
        sig = inspect.signature(fn) if fields else None

        def extract(args, kwargs) -> Dict[str, Any]:
            fvals: Dict[str, Any] = {}
            if fields:
                try:
                    bound = sig.bind_partial(*args, **kwargs)
                    bound.apply_defaults()
                except TypeError:  # never let telemetry break the call
                    return fvals
                for k, fx in fields.items():
                    key = k if k not in ("name", "level") else k + "_"
                    try:
                        fvals[key] = fx(bound.arguments)
                    except Exception:  # one bad extractor keeps the others
                        pass
            return fvals

        if inspect.iscoroutinefunction(fn):  # the span covers the awaited call

            @functools.wraps(fn)
            async def awrapper(*args, **kwargs):
                if not logger.isEnabledFor(level):
                    try:
                        return await fn(*args, **kwargs)
                    except Exception as e:
                        logger.error("%s error: %r", span_name, e)
                        raise
                with span(span_name, level=level, **extract(args, kwargs)):
                    return await fn(*args, **kwargs)

            return awrapper

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not logger.isEnabledFor(level):
                try:
                    return fn(*args, **kwargs)
                except Exception as e:
                    logger.error("%s error: %r", span_name, e)
                    raise
            with span(span_name, level=level, **extract(args, kwargs)):
                return fn(*args, **kwargs)

        return wrapper

    return deco(_fn) if _fn is not None else deco


def decode_telemetry(at_temp: float, avg_logprob: float, no_speech_prob: float) -> None:
    """The reference's decode trace fields (model.rs:180-185)."""
    logger.debug(
        "decoded at_temp=%.1f logprob=%.3f no_speech_prob=%.3f",
        at_temp,
        avg_logprob,
        no_speech_prob,
    )
