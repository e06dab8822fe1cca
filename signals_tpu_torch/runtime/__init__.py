"""Host runtime: the render loop between a compiled patch and an audio
consumer (``signals_tpu.runtime``).

The device renders ahead: a host thread drives the compiled patch in
batches of blocks and hands each block, with its position, to a consumer,
any callable.  A :class:`~signals_tpu_torch.nodes.dev.SinkDevice` makes it
push the blocks into the lock-free native ring
(:mod:`signals_tpu_torch.runtime.ring`, C++), whose consumer — the paced
virtual device (:class:`~signals_tpu_torch.runtime.ring.PacedConsumer`),
a PortAudio output callback (:mod:`signals_tpu_torch.runtime.portaudio`)
or a file descriptor — drains at the sample rate, and passes
``refresh``, so a structural edit of the patch recompiles in the
background while the old program keeps playing (:meth:`Transport.
_swap_async`).  Underruns are counted instead of crashing the stream.
"""

from __future__ import annotations

import threading
import time
import typing

import numpy as np


class Transport:
    """Play/pause/seek state machine driving a compiled patch into a block
    consumer.

    ``consumer(block, position)`` is called with each rendered ``(F, ch)``
    float32 numpy block, in order, from the render thread.  A batch is
    rendered on the patch's device and copied off it once.  The patch's
    carried state (delay lines, streaming filters) stays on the device and
    is threaded from batch to batch; a seek, or a swap to another program,
    starts again from the program's ``carry0``.

    After a seek to a block off a carry-segment boundary (swept-cutoff
    filters, :attr:`~signals_tpu_torch.compiler.CompiledPatch.
    carry_seg_align`), the next render-ahead batch ends on the following
    boundary, so every later batch starts aligned and renders no widened
    lead-in.
    """

    def __init__(self,
                 compiled,
                 consumer: typing.Callable[[np.ndarray, int], None],
                 *,
                 realtime: bool = False,
                 blocks_per_call: int = 8,
                 refresh: typing.Optional[typing.Callable] = None):
        from signals_tpu_torch.utils import LatencyStats
        self.compiled = compiled
        self.consumer = consumer
        self.realtime = realtime
        self.blocks_per_call = blocks_per_call
        #: optional live-edit hook: called between batches, returns the
        #: (possibly re-)compiled patch.  Traced edits (values, enables)
        #: apply without it — params are re-read every render; this catches
        #: *structural* edits (connections, channels)
        self.refresh = refresh
        self.position = 0
        #: per-block render latency metrics (p50/p95, realtime headroom)
        self.stats = LatencyStats()
        #: the exception that stopped the stream, if any
        self.error: typing.Optional[BaseException] = None
        #: the carry after the last batch (None: start from ``carry0``)
        self._carry: typing.Optional[dict] = None
        self._thread: typing.Optional[threading.Thread] = None
        self._running = threading.Event()
        self._lock = threading.Lock()
        #: in-flight structural swap: (new_compiled, done_event) while a
        #: background thread warms the new program up (builds its kernels)
        #: — the OLD program keeps serving audio until the warmup lands
        self._pending: typing.Optional[tuple] = None
        #: monotonic time of the last completed structural swap, for
        #: edit-latency measurement (None until a swap happens)
        self.last_swap_time: typing.Optional[float] = None

    @property
    def is_active(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def warmup(self) -> None:
        """Build the kernels before the clock starts (a first-call build
        would burn seconds of the realtime budget and underrun at once).
        Renders from ``carry0`` and keeps neither audio nor carry."""
        with self._lock:
            self.compiled.render(position=self.position,
                                 n_blocks=self.blocks_per_call)[0].cpu()

    def start(self) -> None:
        if self.is_active:
            return
        self.warmup()
        self._running.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def seek(self, position: int) -> None:
        with self._lock:
            self.position = position
            self._carry = None  # carried state is position-dependent

    def tell(self) -> int:
        return self.position

    def _render(self, n_blocks: int) -> tuple[int, np.ndarray]:
        """``(start position, audio (n*F, ch) numpy)``; the caller holds
        the lock."""
        start = self.position
        t0 = time.perf_counter()
        audio, self._carry = self.compiled.render(
            position=start, n_blocks=n_blocks, carry=self._carry)
        audio = audio.cpu().numpy()
        per_block = (time.perf_counter() - t0) / n_blocks
        for _ in range(n_blocks):
            self.stats.record(per_block)
        self.position = start + n_blocks * self.compiled.block_frames
        return start, audio

    def render(self, n_blocks: int) -> np.ndarray:
        """Synchronous render of ``n_blocks`` from the current position
        (advances the transport); numpy ``(n*F, ch)``."""
        with self._lock:
            return self._render(n_blocks)[1]

    def batch_blocks(self) -> int:
        """Blocks of the next render-ahead batch: ``blocks_per_call``, cut
        short to end on the next carry-segment boundary when the position
        lies off one (after a seek)."""
        F = self.compiled.block_frames
        align = self.compiled.carry_seg_align
        phase = (self.position // F) % align
        if phase:
            return min(self.blocks_per_call, align - phase)
        return self.blocks_per_call

    def render_ahead(self) -> int:
        """Render one batch and hand its blocks to the consumer, one at a
        time with their positions; returns the block count."""
        with self._lock:
            n = self.batch_blocks()
            start, audio = self._render(n)
        F = self.compiled.block_frames
        for i in range(n):
            self.consumer(audio[i * F:(i + 1) * F], start + i * F)
        return n

    def _swap_async(self, new) -> None:
        """Warm the NEW program up (build its kernels) on a background
        thread while the old program keeps serving audio; :meth:`_run`
        swaps it in once the warmup lands.  Programs are told apart by
        their graph hash, so a re-created object of a pending program does
        not restart its warmup."""
        if (self._pending is not None
                and self._pending[0].graph_hash == new.graph_hash):
            return                      # already warming this program
        done = threading.Event()
        pos = self.position
        nb = self.blocks_per_call

        def warm():
            import traceback
            try:
                new.render(position=pos, n_blocks=nb)[0].cpu()
            except Exception:           # surfaced when the swap renders
                traceback.print_exc()
            finally:
                done.set()

        threading.Thread(target=warm, daemon=True).start()
        self._pending = (new, done)

    def _run(self) -> None:
        import traceback
        while self._running.is_set():
            t0 = time.monotonic()
            try:
                if self.refresh is not None:
                    new = self.refresh()
                    if (self._pending is not None
                            and self._pending[0].graph_hash
                            != new.graph_hash):
                        # desire changed (or the edit was reverted while
                        # warming): never swap to a stale program
                        self._pending = None
                    if new.graph_hash != self.compiled.graph_hash:
                        self._swap_async(new)
                if self._pending is not None and self._pending[1].is_set():
                    with self._lock:
                        self.compiled = self._pending[0]
                        self._carry = None
                    self._pending = None
                    self.last_swap_time = time.monotonic()
                n = self.render_ahead()
            except Exception as e:
                # record, log, stop the stream cleanly instead of dying
                # silently on the render thread
                self.error = e
                traceback.print_exc()
                self._running.clear()
                break
            if self.realtime:
                F = self.compiled.block_frames
                budget = n * F / self.compiled.rate - (time.monotonic() - t0)
                if budget > 0:
                    time.sleep(budget)
