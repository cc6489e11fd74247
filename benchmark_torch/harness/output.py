"""The result of a run: its last line on standard output, and the numbers
compared, each beside its limit, as the last lines on standard error."""

import json
import sys

from benchmark_torch.harness import spec


def result_line(bench: dict, record: dict, trace: bool, device: dict) -> dict:
    """The result line of a run: the cell's end-to-end metrics (``trace``
    false) or its per-layer metrics (``trace`` true), each read by
    ``metrics/<name>.py``; a reader that finds nothing leaves its metric
    out."""
    section = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for entry in spec.metrics_of(bench, record['cell'], section):
        value = spec.load_module('metrics', entry['name']).read(record)
        if value is not None:
            metrics[entry['name']] = {'value': value,
                                      'unit': entry['unit']}
    device = dict(device, memory_peak_bytes=record['memory_peak_bytes'])
    line = dict(correct=record['checked'] > 0 and record['failed'] == 0,
                attempted=record['attempted'], failed=record['failed'],
                metrics=metrics, device=device)
    profile = record.get('trace')
    if profile is not None:
        device.update(busy_s=profile.busy_s, window_s=profile.window_s)
        line['breakdown'] = dict(device_ops=profile.device_ops,
                                 idle_gaps=profile.idle_gaps)
    line['checks'] = {k: {'value': v, 'limit': limit}
                      for k, (v, limit) in record['checks'].items()}
    return line


def emit(line: dict) -> None:
    """Print the compared numbers to standard error, then the line (a
    number that is not finite raises: the line would not be JSON)."""
    text = json.dumps(line, allow_nan=False)
    for name, c in line['checks'].items():
        print(f'check {name} = {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(text, flush=True)
