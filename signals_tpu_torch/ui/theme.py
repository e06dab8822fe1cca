"""Theming (reference ``src/signals/ui/theme.py``).

A :class:`SimplePalette` is four colors (back/dark/mid/light) expanded into
the full role palette any frontend needs (window, text, highlights, cables,
plots).  Unlike the reference — whose palettes are PyQt ``QPalette`` objects
— themes here are plain data: hex strings keyed by role, consumable by Qt,
by matplotlib, by a TUI (ANSI), or by an HTML exporter.  A global
:class:`ThemeController` keeps the observer behavior (widgets subscribe to
theme changes, reference ``theme.py:117-135``).
"""

from __future__ import annotations

import typing


def _clamp(v: int) -> int:
    return max(0, min(255, v))


class Color(typing.NamedTuple):
    r: int
    g: int
    b: int

    @classmethod
    def parse(cls, hex_str: str) -> 'Color':
        s = hex_str.lstrip('#')
        return cls(int(s[0:2], 16), int(s[2:4], 16), int(s[4:6], 16))

    def hex(self) -> str:
        return f'#{self.r:02x}{self.g:02x}{self.b:02x}'

    def lighter(self, factor: float = 1.25) -> 'Color':
        return Color(*(_clamp(int(c * factor + 16)) for c in self))

    def darker(self, factor: float = 1.25) -> 'Color':
        return Color(*(_clamp(int(c / factor)) for c in self))

    def mix(self, other: 'Color', t: float = 0.5) -> 'Color':
        return Color(*(_clamp(int(a * (1 - t) + b * t))
                       for a, b in zip(self, other)))

    @property
    def luminance(self) -> float:
        return (0.2126 * self.r + 0.7152 * self.g + 0.0722 * self.b) / 255

    def ansi_fg(self) -> str:
        return f'\x1b[38;2;{self.r};{self.g};{self.b}m'

    def ansi_bg(self) -> str:
        return f'\x1b[48;2;{self.r};{self.g};{self.b}m'


#: roles every frontend can ask a theme for
ROLES = ('window', 'base', 'text', 'bright_text', 'dim_text', 'button',
         'highlight', 'highlighted_text', 'node', 'node_active', 'port',
         'cable', 'cable_active', 'grid_line', 'plot_bg', 'plot_line',
         'warning')


class SimplePalette(typing.NamedTuple):
    """The four seed colors (reference ``theme.py:12-46``)."""

    back: Color
    dark: Color
    mid: Color
    light: Color

    def expand(self) -> dict[str, Color]:
        """Derive the full role map from the four seeds."""
        return {
            'window': self.back,
            'base': self.back.darker(1.2),
            'text': self.light,
            'bright_text': self.light.lighter(),
            'dim_text': self.mid,
            'button': self.dark,
            'highlight': self.mid.lighter(),
            'highlighted_text': self.back,
            'node': self.dark,
            'node_active': self.mid,
            'port': self.light,
            'cable': self.mid,
            'cable_active': self.light.lighter(),
            'grid_line': self.back.mix(self.dark),
            'plot_bg': self.back.darker(1.35),
            'plot_line': self.light,
            'warning': Color(220, 80, 60),
        }

    def replace(self, **seeds: Color) -> 'SimplePalette':
        return self._replace(**seeds)


class Theme:
    """A named, fully-expanded palette."""

    def __init__(self, name: str, palette: SimplePalette,
                 overrides: typing.Optional[dict[str, Color]] = None):
        self.name = name
        self.palette = palette
        self.colors = palette.expand()
        if overrides:
            self.colors.update(overrides)

    def color(self, role: str) -> Color:
        return self.colors[role]

    def __getitem__(self, role: str) -> Color:
        return self.colors[role]

    @property
    def is_dark(self) -> bool:
        return self.colors['window'].luminance < 0.5

    def matplotlib_rc(self) -> dict:
        """rcParams patch so plots match the theme."""
        return {
            'figure.facecolor': self['window'].hex(),
            'axes.facecolor': self['plot_bg'].hex(),
            'axes.edgecolor': self['grid_line'].hex(),
            'axes.labelcolor': self['text'].hex(),
            'xtick.color': self['dim_text'].hex(),
            'ytick.color': self['dim_text'].hex(),
            'lines.color': self['plot_line'].hex(),
            'text.color': self['text'].hex(),
        }


def _c(s: str) -> Color:
    return Color.parse(s)


#: built-in themes: same trio of personalities as the reference
#: (``theme.py:101-114``), re-colored
RED = Theme('Vampire', SimplePalette(
    back=_c('#1a0d10'), dark=_c('#4a1f28'), mid=_c('#a03a4a'),
    light=_c('#e8c0c8')))
GREEN = Theme('Cyborg', SimplePalette(
    back=_c('#0c120d'), dark=_c('#1f3a26'), mid=_c('#3a8a50'),
    light=_c('#c0e8cc')))
WHITE = Theme('Bones', SimplePalette(
    back=_c('#f2efe9'), dark=_c('#c9c2b4'), mid=_c('#8a8172'),
    light=_c('#2a2620')))

THEMES = {t.name: t for t in (RED, GREEN, WHITE)}


class ThemeController:
    """Global observer hub: frontends register callbacks and are notified on
    theme switches (reference ``theme.py:117-135``)."""

    def __init__(self, theme: Theme = GREEN):
        self._theme = theme
        self._subscribers: list[typing.Callable[[Theme], None]] = []

    @property
    def theme(self) -> Theme:
        return self._theme

    def register(self, callback: typing.Callable[[Theme], None]) -> None:
        self._subscribers.append(callback)
        callback(self._theme)

    def unregister(self, callback) -> None:
        self._subscribers = [s for s in self._subscribers if s is not callback]

    def set_theme(self, theme: Theme) -> None:
        self._theme = theme
        for callback in list(self._subscribers):
            callback(theme)


controller = ThemeController()
