"""Simulation configuration and result-merging utilities, a copy of
``ldpc_tpu.monte_carlo_simulation.data_utils``
(reference: src_python/ldpc/monte_carlo_simulation/data_utils.py).

Full pipeline parity: configuration records (``BpParams``), error-rate /
convergence math, the result-bookkeeping helpers (``extract_settings``,
``load_data``, ``create_outpath``) and the JSON merge family
(``merge_datasets``/``merge_json_files`` plus the x/z/xz variants used by
split-sided memory experiments).
"""

import json
from json.decoder import JSONDecodeError
import os
from dataclasses import dataclass, field, fields
from itertools import product
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np


@dataclass
class BpParams:
    """Decoder-configuration record (reference: data_utils.py:15-34)."""

    bp_method: str = "msl"
    max_bp_iter: int = 30
    osd_order: int = 10
    osd_method: str = "osd_cs"
    ms_scaling_factor: float = 0.75
    schedule: str = "parallel"
    omp_thread_count: int = 1
    random_serial_schedule: int = 0
    serial_schedule_order: Optional[List[int]] = None
    cutoff: float = np.inf

    @classmethod
    def from_dict(cls, dict_):
        class_fields = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in dict_.items() if k in class_fields})


def calculate_error_rates(success_cnt: int, runs: int, code_params: Dict):
    """Word/logical error rates with binomial error bars
    (reference: data_utils.py:77-95)."""
    runs = float(runs)
    ler = 1.0 - (success_cnt / runs)
    ler_eb = np.sqrt((1.0 - ler) * ler / runs)
    wer = 1.0 - (1.0 - ler) ** (1.0 / code_params["k"])
    wer_eb = ler_eb * ((1.0 - ler_eb) ** (1.0 / code_params["k"] - 1)) / code_params["k"]
    return ler, ler_eb, wer, wer_eb


def is_converged(
    x_success: int, z_success: int, runs: int, code_params: Dict, precission: float
) -> bool:
    """(reference: data_utils.py:98-105)"""
    return _check_convergence(
        x_success, runs, code_params, precission
    ) and _check_convergence(z_success, runs, code_params, precission)


def _check_convergence(success_cnt, runs, code_params, precission_cutoff):
    if success_cnt == runs:
        return False
    _, _, _, wer_eb = calculate_error_rates(success_cnt, runs, code_params)
    return wer_eb < precission_cutoff


def replace_inf(lst: List) -> List:
    """json-safe: np.inf -> "i" (reference: data_utils.py:190-197)."""
    return ["i" if np.isinf(x) else x for x in lst]


def product_dict(**kwargs):
    """Cartesian product of configuration values
    (reference: data_utils.py:200-207)."""
    keys = kwargs.keys()
    for instance in product(*kwargs.values()):
        yield dict(zip(keys, instance))


def zip_dict(**kwargs):
    """Elementwise zip of configuration values
    (reference: data_utils.py:210-233)."""
    keys = kwargs.keys()
    for instance in zip(*kwargs.values()):
        yield dict(zip(keys, instance))


def _update_error_rates(success_cnt, runs, code_K):
    """(reference: data_utils.py:236-252)"""
    ler, ler_eb, wer, wer_eb = calculate_error_rates(
        success_cnt, runs, {"k": code_K}
    )
    return ler, ler_eb, wer, wer_eb


def extract_settings(filename) -> Dict[str, List[Any]]:
    """Collect the distinct values of every keyword across a
    JSON-lines parameter file (reference: data_utils.py:37-53)."""
    keyword_lists: Dict[str, List[Any]] = {}
    with open(filename, "r") as file:
        for line in file:
            line = line.strip()
            if not line:
                continue
            for keyword, value in json.loads(line).items():
                values = keyword_lists.setdefault(keyword, [])
                if value not in values:
                    values.append(value)
    return keyword_lists


def load_data(input_filenames: List[str]) -> List[Dict]:
    """Load result dicts from JSON files; a file that is missing or
    unparsable triggers a merge of its per-worker directory first
    (reference: data_utils.py:56-74)."""
    data = []
    for file in input_filenames:
        path = Path(file)
        try:
            data.append(json.load(path.open()))
        except (OSError, JSONDecodeError):
            merge_json_files(str(path.with_suffix("")))
            data.append(json.load(path.open()))
    return data


def create_outpath(
    x_meta: bool = False,
    z_meta: bool = False,
    bias: Optional[List[float]] = None,
    codename: Optional[str] = None,
    single_stage: bool = True,
    sus_th_depth: Optional[int] = None,
    rounds: Optional[int] = None,
    id: int = 0,
    overwrite: bool = False,
    analog_info: bool = False,
    analog_tg: bool = False,
    repetitions: Optional[int] = None,
    experiment: str = "wer_per_round",
    results_root: str = "results",
    **kwargs,
) -> str:
    """Build (and reserve) the canonical result-file path for one
    simulation configuration (reference: data_utils.py:117-187; the root
    directory is parameterised instead of hardcoded ``results/``)."""
    path = f"{results_root}/{experiment:s}/"
    if analog_info:
        path += "analog_info/"
    elif analog_tg:
        path += "analog_tg/"
    else:
        path += "hard_syndrome/"
    if bias is not None:
        path += (
            f"single_stage={single_stage}/"
            f"bias={bias[0]}_{bias[1]}_{bias[2]}/"
        )
    if sus_th_depth:
        path += f"sus_th_depth={sus_th_depth}/"
    elif rounds:
        path += f"rounds={rounds}/"
    if repetitions:
        path += f"repetitions={repetitions}/"
    path += "x-meta=true/" if x_meta else "x-meta=false/"
    path += "z-meta=true/" if z_meta else "z-meta=false/"
    path += f"{codename:s}/"

    if "syndr_err_rate" not in kwargs or kwargs["syndr_err_rate"] is None:
        if "sigma" in kwargs:
            path += (
                f"per_{kwargs['data_err_rate']:.3e}"
                f"_sigma_{kwargs['sigma']:.3e}/"
            )
        if "z_sigma" in kwargs:
            path += (
                f"per_{kwargs['data_err_rate']:.3e}"
                f"_x_sigma_{kwargs['x_sigma']:.3e}"
                f"_z_sigma_{kwargs['z_sigma']:.3e}"
            )
    else:
        path += (
            f"per_{kwargs['data_err_rate']:.3e}"
            f"_ser_{kwargs['syndr_err_rate']:.3e}/"
        )

    os.makedirs(path, exist_ok=True)
    f_loc = os.path.join(path, f"id_{id}.json")
    if not overwrite:
        while os.path.exists(f_loc):
            id += 1
            f_loc = os.path.join(path, f"id_{id}.json")
    if not os.path.exists(f_loc):
        open(f_loc, "w").close()
    return f_loc


def merge_datasets(datasets: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate result dicts from independent runs of one experiment
    (reference: data_utils.py:255-303): run counts and success counts
    add; error rates recompute from the merged tallies."""
    if not datasets:
        return {}
    merged = dict(datasets[0])
    runs = sum(int(d.get("nr_runs", 0)) for d in datasets)
    x_success = sum(int(d.get("x_success_cnt", 0)) for d in datasets)
    z_success = sum(int(d.get("z_success_cnt", 0)) for d in datasets)
    merged["nr_runs"] = runs
    merged["x_success_cnt"] = x_success
    merged["z_success_cnt"] = z_success
    if "code_K" in merged and runs:
        for prefix, cnt in (("x", x_success), ("z", z_success)):
            ler, ler_eb, wer, wer_eb = _update_error_rates(
                cnt, runs, merged["code_K"]
            )
            merged[f"{prefix}_ler"] = ler
            merged[f"{prefix}_ler_eb"] = ler_eb
            merged[f"{prefix}_wer"] = wer
            merged[f"{prefix}_wer_eb"] = wer_eb
    return merged


def _merge_datasets_side(
    datasets: List[Dict[str, Any]], side: str
) -> Dict[str, Any]:
    """Merge only the datasets carrying ``<side>_success_cnt``
    (reference: data_utils.py:306-426, _merge_datasets_x/_z)."""
    key = f"{side}_success_cnt"
    kept = [d for d in datasets if key in d]
    if not kept:
        return {}
    merged = dict(kept[0])
    merged["nr_runs"] = sum(int(d.get("nr_runs", 0)) for d in kept)
    success = sum(int(d.get(key, 0)) for d in kept)
    merged[key] = success
    if "code_K" in merged and merged["nr_runs"]:
        ler, ler_eb, wer, wer_eb = _update_error_rates(
            success, merged["nr_runs"], merged["code_K"]
        )
        merged[f"{side}_ler"] = ler
        merged[f"{side}_ler_eb"] = ler_eb
        merged[f"{side}_wer"] = wer
        merged[f"{side}_wer_eb"] = wer_eb
    return merged


def _merge_datasets_x(datasets: List[Dict[str, Any]]) -> Dict[str, Any]:
    return _merge_datasets_side(datasets, "x")


def _merge_datasets_z(datasets: List[Dict[str, Any]]) -> Dict[str, Any]:
    return _merge_datasets_side(datasets, "z")


def _combine_xz_data(
    xdata: Union[Dict, None], zdata: Union[Dict, None]
) -> Dict:
    """Combine per-side merges, renaming nr_runs to x_runs/z_runs
    (reference: data_utils.py:581-601)."""
    if xdata and zdata:
        xdata["x_runs"] = xdata.pop("nr_runs")
        zdata["z_runs"] = zdata.pop("nr_runs")
        xdata.update(zdata)
        return xdata
    if xdata:
        xdata["x_runs"] = xdata.pop("nr_runs")
        return xdata
    if zdata:
        zdata["z_runs"] = zdata.pop("nr_runs")
        return zdata
    return {}


def _merge_json_files(input_path: str, merge_fn) -> None:
    """Shared walk for the merge_json_files family: merge every
    subfolder's JSON files and write ``<parent>/<code_name>.json``
    (reference: data_utils.py:429-463)."""
    output_data: List[Dict[str, Any]] = []
    for folder_name in sorted(os.listdir(input_path)):
        folder_path = os.path.join(input_path, folder_name)
        if not os.path.isdir(folder_path):
            continue
        data: List[Dict[str, Any]] = []
        for filename in sorted(os.listdir(folder_path)):
            if filename.endswith(".json"):
                with open(os.path.join(folder_path, filename)) as f:
                    try:
                        data.append(json.load(f))
                    except JSONDecodeError:
                        pass
        merged = merge_fn(data)
        if merged:
            output_data.append(merged)
    code_name = os.path.basename(os.path.normpath(input_path))
    parent_dir = os.path.abspath(os.path.join(input_path, os.pardir))
    with open(os.path.join(parent_dir, f"{code_name:s}.json"), "w") as f:
        json.dump(output_data, f, ensure_ascii=False, indent=4)


def merge_json_files(input_path: str) -> None:
    """(reference: data_utils.py:429-463)"""
    _merge_json_files(input_path, merge_datasets)


def merge_json_files_x(input_path: str) -> None:
    """(reference: data_utils.py:466-500)"""
    _merge_json_files(input_path, _merge_datasets_x)


def merge_json_files_z(input_path: str) -> None:
    """(reference: data_utils.py:503-537)"""
    _merge_json_files(input_path, _merge_datasets_z)


def merge_json_files_xz(input_path: str) -> None:
    """(reference: data_utils.py:540-578)"""
    _merge_json_files(
        input_path,
        lambda data: _combine_xz_data(
            _merge_datasets_x(data), _merge_datasets_z(data)
        ),
    )
