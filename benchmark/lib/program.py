"""The program's own counter: ``kernels.LAUNCHES``, one count per call of
a hand-written kernel's entry (one per folded ``vmap`` call)."""

from __future__ import annotations


def reset_launches() -> None:
    from signals_tpu_torch.compiler import kernels
    kernels.reset_launch_counts()


def check_launches(cfg: dict, kind: str, units: int, device) -> None:
    """On a card: the kernels that ``units`` calls of ``kind`` launched are
    ``units`` times the configuration's ``expect_launches[kind]``, no more
    and no others; raise otherwise (the cell would not measure the path
    it names)."""
    from signals_tpu_torch.compiler import kernels
    expect = cfg.get('expect_launches', {}).get(kind)
    if expect is None or device.type != 'cuda':
        return
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = {k: v * units for k, v in expect.items()}
    if got != want:
        raise RuntimeError(f'{cfg["name"]}: {units} {kind} call(s) launched '
                           f'{got}, expected {want}')
