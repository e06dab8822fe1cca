"""What the benchmark may import: no module under ``benchmark/`` imports a
top-level ``jax``, ``jaxlib``, ``flax`` or ``signals_tpu`` (top-level names
compared whole: ``signals_tpu_torch`` begins with ``signals_tpu``), and the
references under ``benchmark/reference/`` import nothing of the program
(``signals_tpu_torch``)."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'signals_tpu'}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


SOURCES = sorted(BENCH.rglob('*.py'))


def test_sources_found():
    assert BENCH / 'run.py' in SOURCES
    assert len(SOURCES) > 20


@pytest.mark.parametrize('path', SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    'path', sorted((BENCH / 'reference').glob('*.py')),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert 'signals_tpu_torch' not in top_level_imports(path)
    assert 'signals_tpu_torch' not in path.read_text()


def test_whole_name_comparison(tmp_path):
    probe = tmp_path / 'probe.py'
    probe.write_text('import signals_tpu_torch.parallel\n'
                     'from signals_tpu.x import y\n')
    names = top_level_imports(probe)
    assert names == {'signals_tpu_torch', 'signals_tpu'}
    assert names & FORBIDDEN == {'signals_tpu'}
