"""The package's log with the surface of tcnerf/utils/logging.py (loguru's
`logger.info/debug/warning/error`, `logger.remove`, `logger.add`), on the
standard library's `logging`.

By default it writes INFO and above to the process's current stderr, one
line a message: `<time> | <LEVEL> | <message>`. `remove()` drops every
sink; `add(sink, level)` adds one (any object with `write`, such as a file
or `sys.stderr`). It is its own logger, `tcnerf_torch.log`, which does not
propagate: the trainers' `tcnerf_torch.train` log and the entry points'
`logging.basicConfig` neither see nor repeat its lines.
"""

from __future__ import annotations

import logging as _logging
import sys

_FORMAT = _logging.Formatter("%(asctime)s | %(levelname)-7s | %(message)s",
                             datefmt="%Y-%m-%d %H:%M:%S")


class _Sink(_logging.Handler):
    """Writes formatted lines to `stream`, or to the stderr of the moment
    when `stream` is None (so a redirected stderr is honoured)."""

    def __init__(self, stream=None, level: int = _logging.INFO):
        super().__init__(level)
        self.stream = stream
        self.setFormatter(_FORMAT)

    def emit(self, record: _logging.LogRecord) -> None:
        stream = self.stream if self.stream is not None else sys.stderr
        stream.write(self.format(record) + "\n")
        if hasattr(stream, "flush"):
            stream.flush()


class _Logger:
    def __init__(self, name: str = "tcnerf_torch.log"):
        self._log = _logging.getLogger(name)
        self._log.propagate = False
        self.remove()
        self.add(None)

    def remove(self, *args, **kwargs) -> None:
        for handler in list(self._log.handlers):
            self._log.removeHandler(handler)

    def add(self, sink, level: str = "INFO", **kwargs) -> None:
        levelno = (level if isinstance(level, int)
                   else _logging.getLevelName(level))
        if not isinstance(levelno, int):
            raise ValueError(f"unknown level {level!r}")
        self._log.addHandler(_Sink(sink, levelno))
        self._log.setLevel(min(h.level for h in self._log.handlers))

    def debug(self, message) -> None:
        self._log.debug("%s", message)

    def info(self, message) -> None:
        self._log.info("%s", message)

    def warning(self, message) -> None:
        self._log.warning("%s", message)

    def error(self, message) -> None:
        self._log.error("%s", message)


logger = _Logger()
