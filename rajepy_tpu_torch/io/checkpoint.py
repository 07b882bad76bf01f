"""Portable checkpoints: npz arrays + JSON metadata (a copy of
rajepy_tpu.io.checkpoint; the format tags are the file format's names and
stay the same, so each package reads the other's files).

The reference persists state with pickle (JetModel.save at
classes.py:1704-1713, Pipeline.save at classes.py:2215-2258).  Pickle
remains supported for API parity (JetModel.save / Pipeline.save), but these
npz+JSON checkpoints are the durable format SURVEY §5.4 calls for:
readable across Python versions, inspectable, and free of code-execution
on load.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..utils.misc import atomic_write


def _params_to_jsonable(params: Dict) -> Dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _params_to_jsonable(v)
        elif isinstance(v, np.ndarray):
            out[k] = {'__ndarray__': v.tolist(),
                      'dtype': str(v.dtype)}
        elif isinstance(v, (np.floating, np.integer)):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def _params_from_jsonable(obj):
    if isinstance(obj, dict):
        if '__ndarray__' in obj:
            dt = obj['dtype']
            if dt.startswith('<U') or dt.startswith('str'):
                return np.asarray(obj['__ndarray__'])
            return np.asarray(obj['__ndarray__'], dtype=dt)
        return {k: _params_from_jsonable(v) for k, v in obj.items()}
    return obj


def save_model_checkpoint(path: str, model) -> None:
    """Write ``<path>.json`` (params + time) and ``<path>.npz`` (cached
    fill factors/areas) — the same two-tier state as JetModel.save."""
    meta = {'format': 'rajepy_tpu.model/1',
            'params': _params_to_jsonable(model.params),
            'time': model.time}
    with atomic_write(path + '.json', 'wt') as f:
        json.dump(meta, f, indent=1)
    if model._fields is not None:
        with atomic_write(path + '.npz') as f:
            np.savez_compressed(f, ffs=np.asarray(model.fill_factor),
                                areas=np.asarray(model.areas))


def load_model_checkpoint(path: str, log=None, dtype='auto', device='cuda'):
    """Rebuild a JetModel from an npz/JSON checkpoint, on ``device`` at
    ``dtype`` (defaults as ``JetModel``'s)."""
    from ..models.jetmodel import JetModel
    with open(path + '.json', 'rt') as f:
        meta = json.load(f)
    params = _params_from_jsonable(meta['params'])
    jm = JetModel(params, log=log, dtype=dtype, device=device)
    if os.path.exists(path + '.npz'):
        arrs = np.load(path + '.npz')
        jm._inject_cached_ff(arrs['ffs'], arrs['areas'])
    jm.time = meta['time']
    return jm


def save_pipeline_checkpoint(path: str, pipeline) -> None:
    """JSON run-state checkpoint mirroring Pipeline.save's content: per-run
    completion flags, results and product paths."""
    runs = []
    for run in pipeline.runs:
        entry = {
            'obs_type': run.obs_type,
            'year': run.year,
            'freq': run.freq,
            'line': getattr(run, 'line', None),
            'bandwidth': run.bandwidth,
            'chanwidth': run.chanwidth,
            't_obs': run.t_obs,
            't_int': run.t_int,
            'tscop': list(run.tscop) if run.tscop else None,
            'completed': run.completed,
            'products': run.products,
            'results': _params_to_jsonable(
                {k: v for k, v in run.results.items()}),
        }
        runs.append(entry)
    meta = {'format': 'rajepy_tpu.pipeline/1',
            'params': _params_to_jsonable(pipeline.params),
            'model_file': pipeline.model_file,
            'runs': runs}
    with atomic_write(path, 'wt') as f:
        json.dump(meta, f, indent=1, default=str)


def load_pipeline_state(path: str) -> Dict:
    """Read a pipeline JSON checkpoint (params/run-state dict)."""
    with open(path, 'rt') as f:
        meta = json.load(f)
    meta['params'] = _params_from_jsonable(meta['params'])
    for entry in meta.get('runs', []):
        # results were encoded with _params_to_jsonable on save — decode
        # symmetrically or ndarrays come back as {'__ndarray__': ...}
        if entry.get('results') is not None:
            entry['results'] = _params_from_jsonable(entry['results'])
    return meta
