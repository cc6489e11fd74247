"""The harness finds every part of the benchmark by its name."""

import pytest
import torch

from benchmark_torch.harness import readers, spec


@pytest.fixture(scope='module')
def bench():
    return spec.benchmark()


def test_every_cell_has_its_files(bench):
    for entry in bench['workloads']:
        cell = spec.load_part('workloads', entry['name'])
        assert (cell['config'], cell['traffic']) == (entry['config'],
                                                    entry['traffic'])
        cfg = spec.load_part('configs', entry['config'])
        assert cfg['name'] == entry['config']
        assert spec.load_part('traffic', entry['traffic'])['kind'] == 'trials'
        for kind in ('reference', 'work'):
            spec.load_module(kind, entry['config'])
        spec.load_module('drivers', cfg['driver'])


def test_every_cell_file_has_its_parts():
    # the cells BENCHMARK.json does not list yet (PERF.md, 7) as well
    for path in sorted((spec.BENCH_DIR / 'workloads').glob('*.json')):
        cell = spec.load_json(path)
        cfg = spec.load_part('configs', cell['config'])
        spec.load_part('traffic', cell['traffic'])
        for kind in ('reference', 'work'):
            spec.load_module(kind, cfg['name'])


def test_every_config_file_is_the_named_one(bench):
    for entry in bench['configs']:
        assert entry['file'] == f'benchmark_torch/configs/{entry["name"]}.json'
        assert spec.load_part('configs', entry['name'])['reduced'] == \
            entry['reduced']


@pytest.mark.parametrize('section', ['end_to_end', 'per_layer'])
def test_every_metric_has_a_reader(bench, section):
    for entry in bench[section]:
        assert callable(spec.load_module('metrics', entry['name']).read)


def test_each_per_layer_metric_moves_a_metric_its_cells_report(bench):
    for m in bench['per_layer']:
        for cell in m['workloads']:
            names = {e['name'] for e in spec.metrics_of(bench, cell,
                                                        'end_to_end')}
            assert m['moves'] in names and 'setup_s' in names


def test_metrics_of_a_cell(bench):
    names = {m['name'] for m in spec.metrics_of(bench, 'coba_ei.400k',
                                                'end_to_end')}
    assert names == {'ei_us_per_step', 'setup_s'}
    names = {m['name'] for m in spec.metrics_of(bench, 'coba_ei.4k',
                                                'per_layer')}
    assert names == {'launches_per_step.ei_small', 'kernel_roofline.ei_small',
                     'step_mfu.ei_small', 'device_idle_pct.ei_small'}


@pytest.mark.parametrize('name', ['../run', 'a/b', '.hidden', '', 'x' * 65])
def test_a_path_is_not_a_name(name):
    with pytest.raises(ValueError):
        spec.part('metrics', name, '.py')


def test_a_missing_part_raises():
    with pytest.raises(FileNotFoundError):
        spec.load_module('metrics', 'no_such_metric')


def test_device_readers_read_nothing_from_a_cpu_run():
    record = dict(platform='cpu', trace=None, seconds=2.0, steps=4000,
                  setup_s=1.5, window_work=(1e9, 1e6))
    assert readers.us_per_step(record) == 500.0
    assert readers.setup_s(record) == 1.5
    for read in (readers.launches_per_step, readers.kernel_roofline_pct,
                 readers.step_mfu_pct, readers.device_idle_pct):
        assert read(record) is None


def test_the_sample_is_uniform_and_small():
    from benchmark_torch.drivers.trials import Sample
    hits = [0] * 10
    for seed in range(2000):
        sample = Sample(seed, 2)
        for i in range(10):
            sample.offer(i, i)
            assert len(sample.kept) <= 2
        for i in sample.kept:
            hits[i] += 1
    assert all(330 < h < 470 for h in hits), hits
