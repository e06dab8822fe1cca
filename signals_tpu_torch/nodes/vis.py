"""Visualization taps (``signals_tpu.nodes.vis``; reference
``src/signals/chain/vis.py``).

A ``Vis`` node forwards its input unchanged and queues a copy for the UI
thread — the PASSTHRU side-effect design (reference ``vis.py:19-64``).
In the compiled engine the tap is an extra render output delivered to
``consume_tap`` after the device call, or reduced on the device to a
display summary (``CompiledPatch.render_vis``).  ``Spec`` is implemented
properly (rfft magnitude bands); the reference's version is a marked-broken
sketch (``vis.py:87-89``).  matplotlib is never imported here: the drawing
methods take the ``Axes`` they draw on.
"""

from __future__ import annotations

import abc
import queue

import numpy as np

from signals_tpu_torch import SignalFlags
from signals_tpu_torch.core import Request, Shape
from signals_tpu_torch.core.state import Param
from signals_tpu_torch.graph import KernelCtx, PassThroughResult
from signals_tpu_torch.registry import register


#: plot-point budget per summary: the reference's vis rack consumes at
#: most 1500 frames per 30 ms tick (reference ``ui/vis.py:17-19``) —
#: min+max per bucket lands exactly on that budget
VIS_SUMMARY_BUCKETS = 750


class Vis(PassThroughResult, abc.ABC):

    def __init__(self):
        super().__init__()
        self.q: queue.Queue = queue.Queue()
        #: device-decimated summaries (:meth:`tap_summary` outputs fetched
        #: by ``CompiledPatch.render_vis``) — a plot needs ~1500 points,
        #: so full-rate audio never crosses the host link for these
        self.summary_q: queue.Queue = queue.Queue()

    @classmethod
    def flags(cls) -> SignalFlags:
        return super().flags() | SignalFlags.VIS

    def kernel(self, ctx: KernelCtx):
        return ctx.in_('input')

    def consume_tap(self, block: np.ndarray, position: int,
                    rate: int) -> None:
        self.q.put(np.asarray(block))

    # --- device-side decimation (no reference counterpart: the reference
    # queues full-rate blocks between threads, vis.py:19-64; a plot needs
    # ~1500 points, so the summary is computed on the device and only
    # those are copied to the host) --------------------------------------

    @abc.abstractmethod
    def tap_summary(self, xp, x, rate: int):
        """Device-side display summary of a full-rate window ``x``
        ``(T, ch)`` — same math under numpy (``xp`` numpy itself or the
        oracle's namespace) and torch (compiled).  Shapes depend only on
        T, rate and structural state."""
        raise NotImplementedError

    def consume_summary(self, summary: np.ndarray, frames: int,
                        position: int, rate: int) -> None:
        """Deliver a fetched :meth:`tap_summary` result (host side)."""
        self.summary_q.put((np.asarray(summary), frames, position, rate))

    def latest_summary(self):
        """Drain the summary queue, returning the newest entry or None."""
        latest = None
        while True:
            try:
                latest = self.summary_q.get_nowait()
            except queue.Empty:
                return latest

    @abc.abstractmethod
    def _plot_summary(self, summary: np.ndarray, frames: int, rate: int,
                      ax) -> list:
        raise NotImplementedError

    # pull engine: queue inline, exactly like the reference (vis.py:61-64)
    def _eval(self, request: Request) -> np.ndarray:
        result = super()._eval(request)
        self.consume_tap(result, request.loc.position, request.loc.rate)
        return result

    def drain(self, frames: int) -> list[np.ndarray]:
        """Pop queued blocks up to a total of ``frames``; excess blocks are
        dropped (reference ``vis.py:29-44``)."""
        blocks = []
        queued = 0
        while True:
            try:
                block = self.q.get_nowait()
            except queue.Empty:
                break
            queued += Shape.of_array(block).frames
            if queued <= frames:
                blocks.append(block)
        return blocks

    def render(self, ax, frames: int) -> list:
        """Draw onto a matplotlib Axes (reference ``vis.py:29-55``).

        Full-rate queued blocks (realtime playback path) win; with none
        queued, the newest device-decimated summary (offline
        ``render_vis`` path) is drawn instead."""
        blocks = self.drain(frames)
        ax.clear()
        result = []
        if blocks:
            x = 0
            for block in blocks[:-1]:
                x += Shape.of_array(block).frames
                result.append(ax.axvline(x, c='black'))
            result.extend(self._plot(np.concatenate(blocks), ax))
            ax.set_xlim(0, frames)
            return result
        latest = self.latest_summary()
        if latest is not None:
            summary, sframes, _pos, srate = latest
            result.extend(self._plot_summary(summary, sframes, srate, ax))
            ax.set_xlim(0, sframes)
            return result
        ax.set_xlim(0, frames)
        return result

    @abc.abstractmethod
    def _plot(self, block: np.ndarray, ax) -> list:
        raise NotImplementedError


@register('signals.chain.vis.Wave')
class Wave(Vis):

    class State(Vis.State):
        min_amp: float = Param(-1.0)
        max_amp: float = Param(+1.0)

    def _plot(self, block: np.ndarray, ax) -> list:
        ax.set_ylim(self._state.min_amp, self._state.max_amp)
        return ax.plot(block)

    def tap_summary(self, xp, x, rate: int):
        """Per-pixel min/max envelope ``(P, 2, ch)`` with ``P <= 750``
        buckets — what a waveform display actually draws.  The tail
        bucket pads by repeating the last frame (neutral for min AND
        max)."""
        T, ch = x.shape
        P = min(T, VIS_SUMMARY_BUCKETS)
        k = -(-T // P)
        pad = P * k - T
        if pad:
            x = xp.concatenate(
                [x, xp.broadcast_to(x[-1:, :], (pad, ch))], axis=0)
        xb = xp.reshape(x, (P, k, ch))
        return xp.stack([xp.min(xb, axis=1), xp.max(xb, axis=1)], axis=1)

    def _plot_summary(self, summary: np.ndarray, frames: int, rate: int,
                      ax) -> list:
        ax.set_ylim(self._state.min_amp, self._state.max_amp)
        P = summary.shape[0]
        t = np.linspace(0, frames, P)
        out = []
        for c in range(summary.shape[2]):
            out.append(ax.fill_between(t, summary[:, 0, c],
                                       summary[:, 1, c], alpha=0.8))
        return out


@register('signals.chain.vis.Spec')
class Spec(Vis):
    """Magnitude spectrum bars over ``bands`` linear frequency bins."""

    class State(Vis.State):
        min_freq: float = Param(0.0)
        max_freq: float = Param(22000.0)
        bands: int = Param(80)

    def _binning(self, n_frames: int, rate: int):
        """Static (centers, bin_index_of_selected, selected_fft_rows) for
        pooling an ``n_frames``-point rfft into the state's bands — host
        constants, so the device pooling is a static scatter.  The newest
        result is kept: a 60 s window has 1.3 M rfft rows, and an eager
        render would otherwise sort them into bands on the host at every
        call."""
        lo, hi = self._state.min_freq, self._state.max_freq
        bands = max(int(self._state.bands), 1)
        key = (n_frames, rate, lo, hi, bands)
        cached = getattr(self, '_bins', None)
        if cached is not None and cached[0] == key:
            return cached[1]
        freqs = np.fft.rfftfreq(n_frames, d=1.0 / rate)
        edges = np.linspace(lo, hi, bands + 1)
        centers = 0.5 * (edges[:-1] + edges[1:])
        idx = np.clip(np.searchsorted(edges, freqs) - 1, 0, bands - 1)
        sel = np.nonzero((freqs >= lo) & (freqs <= hi))[0]
        self._bins = (key, (centers, idx[sel], sel), {})
        return self._bins[1]

    def _device_binning(self, n_frames: int, rate: int, device):
        """:meth:`_binning`'s two index arrays as int64 tensors on
        ``device``, copied there once per binning."""
        _, idx_sel, sel = self._binning(n_frames, rate)
        on_device = self._bins[2]
        if device not in on_device:
            import torch
            on_device[device] = tuple(
                torch.as_tensor(a, dtype=torch.int64, device=device)
                for a in (idx_sel, sel))
        return on_device[device]

    def spectrum(self, block: np.ndarray, rate: int) -> tuple[np.ndarray, np.ndarray]:
        """(band_centers_hz, magnitudes) pooled into ``bands`` bins."""
        centers, idx_sel, sel = self._binning(len(block), rate)
        mono = block.mean(axis=1)
        mags = np.abs(np.fft.rfft(mono)) / max(len(mono), 1)
        pooled = np.zeros(max(int(self._state.bands), 1))
        np.maximum.at(pooled, idx_sel, mags[sel])
        return centers, pooled

    def tap_summary(self, xp, x, rate: int):
        """Device FFT + static scatter-max pooling: the fetched summary
        is just ``bands`` magnitudes — identical math to
        :meth:`spectrum` on the same window."""
        T, ch = x.shape
        bands = max(int(self._state.bands), 1)
        mono = xp.mean(x, axis=1)
        mags = xp.abs(xp.fft.rfft(mono)) / max(T, 1)
        if not getattr(xp, 'is_torch', False):
            _, idx_sel, sel = self._binning(T, rate)
            pooled = np.zeros(bands, dtype=np.float64)
            np.maximum.at(pooled, idx_sel, mags[sel])
            return pooled
        # f32 FFT on the device; magnitudes are >= 0, so a scatter-max
        # into zeros is the pooling
        import torch
        idx, rows = self._device_binning(T, rate, mags.device)
        pooled = torch.zeros(bands, dtype=mags.dtype, device=mags.device)
        return pooled.scatter_reduce_(0, idx, mags[rows], 'amax')

    def _plot_summary(self, summary: np.ndarray, frames: int, rate: int,
                      ax) -> list:
        centers, _, _ = self._binning(max(frames, 1), rate)
        width = (centers[1] - centers[0]) if len(centers) > 1 else 1.0
        return list(ax.bar(centers, summary, width=width))

    def _plot(self, block: np.ndarray, ax) -> list:
        rate = 44100 if self._last_request is None else self._last_request.loc.rate
        centers, mags = self.spectrum(block, rate)
        width = (centers[1] - centers[0]) if len(centers) > 1 else 1.0
        ax.set_xlim(self._state.min_freq, self._state.max_freq)
        return list(ax.bar(centers, mags, width=width * 0.9))
