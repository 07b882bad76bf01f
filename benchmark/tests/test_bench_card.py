"""One short run of a cell on the card, end to end through run.py:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.cuda


def test_a_short_run_on_the_card_is_correct(card):
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'example_jet_shipped.sed16_runs', '--seed',
                        str(2 ** 31 + 5), '--seconds', '2'], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out['correct'] and out['device']['platform'] == 'gpu'
    assert set(out['metrics']) == {'setup_s', 'peak_mem_gib'}
    assert list(out)[-1] == 'checks'
    assert p.stderr.strip().splitlines()[-1].startswith('check ')
