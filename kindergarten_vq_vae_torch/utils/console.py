"""Styled console output: epoch lines and an in-place progress line (stdlib only).

The port's copy of ``kindergarten_vq_vae_tpu/utils/console.py``: 24-bit
ANSI styling, the reference's stage palette and best-marker emojis, and
``ProgressLine`` (spinner, bar, M/N, elapsed, remaining, it/s). Styling is
off when stdout is not a TTY or ``NO_COLOR`` is set, so piped logs and
tests see plain text.
"""

from __future__ import annotations

import os
import sys
import time

# Reference palette (common/consts.py:17-25).
COLOR_EPOCH = "#BD1376"
COLOR_RUN_ID = COLOR_EPOCH
COLOR_TRAIN = "#2A9CDA"
COLOR_VAL = "#6A16A5"
COLOR_TEST = "#914418"
COLOR_FROZEN = "#E71111"
COLOR_TOT = "#3C493F"
COLOR_WARNING = "#b89d0b"

STAGE_COLORS = {"train": COLOR_TRAIN, "val": COLOR_VAL, "test": COLOR_TEST}

# Reference best-marker emojis (common/consts.py:27-29), as literal glyphs
# (rich resolves ':rocket:'-style codes; we ship the codepoints directly).
STATS_EMOJI = {
    "train": ("\U0001f389", "\U0001f680", "\U0001f973", "\U0001f525"),
    "val": ("\U0001f381", "\U0001f3c8", "\U0001f409", "\U0001f480"),
    "test": ("\U0001f920", "\U0001f52e", "\U0001f9f8", "\U0001f4cd"),
}

_SPINNER = "⠋⠙⠹⠸⠼⠴⠦⠧⠇⠏"


def color_enabled(stream=None) -> bool:
    stream = stream or sys.stdout
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("FORCE_COLOR"):
        return True
    return hasattr(stream, "isatty") and stream.isatty()


def _sgr_rgb(hex_color: str) -> str:
    h = hex_color.lstrip("#")
    r, g, b = int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16)
    return f"38;2;{r};{g};{b}"


def style(text: str, color: str | None = None, bold: bool = False,
          enable: bool | None = None) -> str:
    """rich-like inline styling: 24-bit foreground + bold."""
    if enable is None:
        enable = color_enabled()
    if not enable or (color is None and not bold):
        return text
    codes = []
    if bold:
        codes.append("1")
    if color:
        codes.append(_sgr_rgb(color))
    return f"\x1b[{';'.join(codes)}m{text}\x1b[0m"


class ProgressLine:
    """Single-line progress renderer (spinner | bar | pct | M/N | elapsed |
    remaining | speed), info-equivalent to the reference's rich Progress
    columns (models/bagon/main.py:83-96). Renders in place via ``\\r`` on a
    TTY; completely silent otherwise (so batch logs stay line-oriented).
    """

    def __init__(self, description: str, total: int, stream=None,
                 bar_width: int = 24):
        self.desc = description
        self.total = max(int(total), 1)
        self.stream = stream or sys.stdout
        self.bar_width = bar_width
        self.n = 0
        self.t0 = time.perf_counter()
        self._live = color_enabled(self.stream)
        self._spin_i = 0

    def advance(self, n: int = 1) -> None:
        self.n += n
        if self._live:
            self._render()

    def _render(self) -> None:
        frac = min(self.n / self.total, 1.0)
        filled = int(frac * self.bar_width)
        bar = "━" * filled + "─" * (self.bar_width - filled)
        elapsed = time.perf_counter() - self.t0
        speed = self.n / elapsed if elapsed > 0 else 0.0
        remain = (self.total - self.n) / speed if speed > 0 else float("inf")
        rem_s = "--:--" if remain == float("inf") else f"{int(remain) // 60:02d}:{int(remain) % 60:02d}"
        spin = _SPINNER[self._spin_i % len(_SPINNER)]
        self._spin_i += 1
        line = (
            f"\r{spin} {self.desc} {style(bar, '#008000' if frac >= 1 else None)} "
            f"{frac * 100:6.2f}% {self.n}/{self.total} • "
            f"{int(elapsed) // 60:02d}:{int(elapsed) % 60:02d} • {rem_s} "
            f"• {speed:.1f} it/s"
        )
        self.stream.write(line)
        self.stream.flush()

    def clear(self) -> None:
        """Erase the in-place line so regular prints land on a clean row."""
        if self._live:
            self.stream.write("\r\x1b[2K")
            self.stream.flush()

    def close(self) -> None:
        if self._live:
            self._render()
            self.stream.write("\n")
            self.stream.flush()


def epoch_line(epoch: int, stage: str, parts: list[str],
               best_flags: list[bool] | None = None) -> str:
    """Assemble a styled epoch line: bold-magenta epoch number, per-stage
    colored stats, reference best-marker emojis (Trainer.py:157-172).
    ``parts`` are the pre-formatted stat strings; ``best_flags`` aligns with
    them (True -> append the stage's emoji marker, like the reference's
    ``stat_emojis[i] if ..._is_best else '  '``).
    """
    on = color_enabled()
    c = STAGE_COLORS.get(stage)
    emo = STATS_EMOJI.get(stage, STATS_EMOJI["train"])
    out = [style(f"{epoch:03d}", COLOR_EPOCH, bold=True, enable=on) + f" | {stage:<5}"]
    for i, p in enumerate(parts):
        marker = ""
        if best_flags is not None and i < len(best_flags):
            marker = f" {emo[(i + 1) % len(emo)]}" if (best_flags[i] and on) else ""
        out.append(style(p, c, bold=True, enable=on) + marker)
    return " | ".join(out)
