"""Typed configuration for the MANSY PyTorch port.

A framework-free copy of ``mansy_immersivevideostreaming_tpu/config.py``; the
port keeps its own so that it never imports the JAX package.  ``yaml`` is
imported only by :func:`load_config`, so the package itself needs no PyYAML.

The reference spreads one ``config.yml`` (reference ``config.yml:1-157``) across
three copies of ``get_config_from_yml()`` (reference
``dataset_preprocess/utils.py:8-33``, ``viewport_prediction/utils/common.py:10-34``,
``bitrate_selection/utils/common.py:13-37``).  Here there is a single typed
config object.  The YAML schema is kept compatible: :func:`load_config` reads the
same file layout, so a user of the reference can point this framework at their
existing ``config.yml`` and datasets.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Sequence, Tuple

# Default location of the reference-format dataset tree: ``datasets`` under the
# working directory, or wherever the MANSY_DATA_DIR environment variable points.
DEFAULT_DATA_DIR = os.environ.get("MANSY_DATA_DIR", os.path.join(os.getcwd(), "datasets"))
DEFAULT_RESULTS_DIR = os.environ.get("MANSY_RESULTS_DIR", os.path.join(os.getcwd(), "results"))
DEFAULT_MODELS_DIR = os.environ.get("MANSY_MODELS_DIR", os.path.join(os.getcwd(), "models"))


@dataclasses.dataclass(frozen=True)
class Config:
    """Mirror of the reference ``config.yml`` schema (reference ``config.yml``)."""

    # --- directories -----------------------------------------------------
    datasets_base_dir: str = DEFAULT_DATA_DIR
    results_base_dir: str = DEFAULT_RESULTS_DIR
    models_base_dir: str = DEFAULT_MODELS_DIR
    raw_datasets_dir: Mapping[str, str] = dataclasses.field(default_factory=dict)
    raw_network_datasets_dir: Mapping[str, str] = dataclasses.field(default_factory=dict)
    viewport_datasets_dir: Mapping[str, str] = dataclasses.field(default_factory=dict)
    video_datasets_dir: Mapping[str, str] = dataclasses.field(default_factory=dict)
    network_datasets_dir: Mapping[str, str] = dataclasses.field(default_factory=dict)
    vp_results_dir: str = ""
    bs_results_dir: str = ""
    vp_models_dir: str = ""
    bs_models_dir: str = ""

    # --- dataset enumeration --------------------------------------------
    datasets_list: Sequence[str] = ("Jin2022",)
    network_datasets_list: Sequence[str] = ("4G",)
    # video id -> (length_sec, width, height); reference config.yml:30-59
    video_info: Mapping[str, Mapping[int, Tuple[int, int, int]]] = dataclasses.field(default_factory=dict)
    video_num: Mapping[str, int] = dataclasses.field(default_factory=dict)
    user_num: Mapping[str, int] = dataclasses.field(default_factory=dict)

    # --- tiling (reference config.yml:67-75) -----------------------------
    tile_num_width: int = 8
    tile_num_height: int = 8
    tile_total_num: int = 64
    video_width: int = 2560
    video_height: int = 1440
    chunk_length: int = 1
    video_rates: Sequence[int] = (1, 5, 8, 16, 35)

    # --- network traces (reference config.yml:78-127) --------------------
    network_info: Mapping[str, Mapping[int, str]] = dataclasses.field(default_factory=dict)
    network_split: Mapping[str, Mapping[str, Sequence[int]]] = dataclasses.field(default_factory=dict)

    # --- splits (reference config.yml:129-144) ---------------------------
    video_split: Mapping[str, Mapping[str, Sequence[int]]] = dataclasses.field(default_factory=dict)
    user_split: Mapping[str, Mapping[str, Sequence[int]]] = dataclasses.field(default_factory=dict)
    qoe_split: Mapping[str, Sequence[Sequence[int]]] = dataclasses.field(default_factory=dict)

    # --- viewport sampling (reference config.yml:146-150) ----------------
    trim_head: int = 15
    trim_tail: int = 15
    frequency: int = 5
    sample_step: int = 5

    # --- streaming (reference config.yml:152-157) ------------------------
    startup_download: int = 5
    max_size: float = 500000.0
    max_throughput: float = 5000000.0
    past_k: int = 8
    action_space: int = 15

    # Derived tiling constants (fixes the reference's missing
    # config.tile_width/tile_height bug: reference predict.py:41-45 reads
    # attributes that do not exist in config.yml).
    @property
    def tile_width(self) -> int:
        return self.video_width // self.tile_num_width

    @property
    def tile_height(self) -> int:
        return self.video_height // self.tile_num_height

    @property
    def num_rates(self) -> int:
        return len(self.video_rates)

    # --- convenience path accessors --------------------------------------
    def viewport_dir(self, dataset: str) -> str:
        return self.viewport_datasets_dir.get(dataset) or os.path.join(
            self.datasets_base_dir, dataset, "viewports"
        )

    def manifest_dir(self, dataset: str) -> str:
        return self.video_datasets_dir.get(dataset) or os.path.join(
            self.datasets_base_dir, dataset, "video_manifests"
        )

    def network_dir(self, network_dataset: str) -> str:
        return self.network_datasets_dir.get(network_dataset) or os.path.join(
            self.datasets_base_dir, "network", network_dataset
        )


# Built-in defaults replicating the reference's shipped config.yml so the
# framework runs without any YAML file present (values from reference
# config.yml:30-157).
_JIN2022_VIDEO_INFO: Dict[int, Tuple[int, int, int]] = {}
for _v in range(1, 28):
    _len = 58 if _v in (9, 18, 27) else 60
    if _v <= 9:
        _res = (1280, 720)
    elif _v <= 18:
        _res = (1920, 1080)
    else:
        _res = (2560, 1440)
    _JIN2022_VIDEO_INFO[_v] = (_len, _res[0], _res[1])

_4G_TRACES: Dict[int, str] = {}
_trace_names = (
    [f"report_bicycle_{i:04d}.pkl" for i in (1, 2)]
    + [f"report_bus_{i:04d}.pkl" for i in range(1, 12)]
    + [f"report_car_{i:04d}.pkl" for i in range(1, 9)]
    + [f"report_foot_{i:04d}.pkl" for i in range(1, 9)]
    + [f"report_train_{i:04d}.pkl" for i in range(1, 4)]
    + [f"report_tram_{i:04d}.pkl" for i in range(1, 9)]
)
for _i, _n in enumerate(_trace_names):
    _4G_TRACES[_i] = _n

DEFAULT_NETWORK_SPLIT = {
    "4G": {
        "train": [26, 24, 4, 9, 39, 29, 30, 1, 12, 10, 2, 3, 25, 14, 15, 0, 36, 17, 8, 19, 11, 35, 21, 5],
        "valid": [22, 32, 7, 20, 18, 6, 38, 37],
        "test": [31, 33, 16, 23, 13, 28, 27, 34],
    }
}

DEFAULT_VIDEO_SPLIT = {
    "Jin2022": {
        "train": [1, 2, 3, 4, 6, 8, 9, 10, 11, 13, 15, 17, 18, 19, 20, 22, 23, 24],
        "valid": [12, 5, 7],
        "test": [21, 14, 16],
    }
}

# NOTE: valid == train for users is a quirk of the reference preserved on
# purpose (reference config.yml:137-138).
_USER_TRAIN = [22, 27, 30, 39, 44, 57, 59, 1, 9, 16, 20, 21, 46, 48, 51, 53, 2, 5, 6, 7,
               12, 19, 25, 26, 28, 33, 36, 38, 47, 8, 15, 18, 29, 31, 34, 35, 41, 45, 49,
               50, 54, 4, 17, 37, 43]
DEFAULT_USER_SPLIT = {
    "Jin2022": {
        "train": list(_USER_TRAIN),
        "valid": list(_USER_TRAIN),
        "test": [3, 10, 14, 24, 32, 40, 52, 55, 58, 60, 11, 13, 23, 42, 56],
    }
}

DEFAULT_QOE_SPLIT = {
    "train": [[7, 1, 1], [1, 7, 1], [1, 1, 7], [3, 3, 3]],
    "valid": [[7, 1, 1], [1, 7, 1], [1, 1, 7], [3, 3, 3]],
    "test": [[5, 1, 3], [2, 4, 3], [1, 3, 5], [4, 4, 1]],
}


def default_config(datasets_base_dir: str = DEFAULT_DATA_DIR,
                   results_base_dir: str = DEFAULT_RESULTS_DIR,
                   models_base_dir: str = DEFAULT_MODELS_DIR) -> Config:
    """Build a config with the reference's shipped values baked in."""
    return Config(
        datasets_base_dir=datasets_base_dir,
        results_base_dir=results_base_dir,
        models_base_dir=models_base_dir,
        viewport_datasets_dir={"Jin2022": os.path.join(datasets_base_dir, "Jin2022", "viewports")},
        video_datasets_dir={"Jin2022": os.path.join(datasets_base_dir, "Jin2022", "video_manifests")},
        network_datasets_dir={"4G": os.path.join(datasets_base_dir, "network", "4G")},
        vp_results_dir=os.path.join(results_base_dir, "viewport_prediction"),
        bs_results_dir=os.path.join(results_base_dir, "bitrate_selection"),
        vp_models_dir=os.path.join(models_base_dir, "viewport_prediction"),
        bs_models_dir=os.path.join(models_base_dir, "bitrate_selection"),
        video_info={"Jin2022": dict(_JIN2022_VIDEO_INFO)},
        video_num={"Jin2022": 27},
        user_num={"Jin2022": 60},
        network_info={"4G": dict(_4G_TRACES)},
        network_split=DEFAULT_NETWORK_SPLIT,
        video_split=DEFAULT_VIDEO_SPLIT,
        user_split=DEFAULT_USER_SPLIT,
        qoe_split=DEFAULT_QOE_SPLIT,
    )


def load_config(config_yml_path: str | None = None) -> Config:
    """Load a reference-format ``config.yml`` into a typed :class:`Config`.

    Replicates the path-concatenation behavior of the reference loader
    (reference ``bitrate_selection/utils/common.py:13-37``).  When no file is
    given, returns :func:`default_config`.
    """
    if config_yml_path is None:
        return default_config()
    import yaml

    with open(config_yml_path, "r", encoding="utf8") as f:
        raw = yaml.safe_load(f)

    base = raw["datasets_base_dir"]

    def _join(d: Mapping[str, str]) -> Dict[str, str]:
        return {k: base + v for k, v in d.items()}

    video_info = {
        ds: {int(v): tuple(info) for v, info in vids.items()}
        for ds, vids in raw["video_info"].items()
    }
    network_info = {
        nds: {int(k): v for k, v in traces.items()}
        for nds, traces in raw["network_info"].items()
    }
    return Config(
        datasets_base_dir=base,
        results_base_dir=raw["results_base_dir"],
        models_base_dir=raw["models_base_dir"],
        raw_datasets_dir=_join(raw.get("raw_datasets_dir", {})),
        raw_network_datasets_dir=_join(raw.get("raw_network_datasets_dir", {})),
        viewport_datasets_dir=_join(raw["viewport_datasets_dir"]),
        video_datasets_dir=_join(raw["video_datasets_dir"]),
        network_datasets_dir=_join(raw["network_datasets_dir"]),
        vp_results_dir=raw["results_base_dir"] + raw["vp_results_dir"],
        bs_results_dir=raw["results_base_dir"] + raw["bs_results_dir"],
        vp_models_dir=raw["models_base_dir"] + raw["vp_models_dir"],
        bs_models_dir=raw["models_base_dir"] + raw["bs_models_dir"],
        datasets_list=tuple(raw["datasets_list"]),
        network_datasets_list=tuple(raw["network_datasets_list"]),
        video_info=video_info,
        video_num={k: int(v) for k, v in raw["video_num"].items()},
        user_num={k: int(v) for k, v in raw["user_num"].items()},
        tile_num_width=raw["tile_num_width"],
        tile_num_height=raw["tile_num_height"],
        tile_total_num=raw["tile_total_num"],
        video_width=raw["video_width"],
        video_height=raw["video_height"],
        chunk_length=raw["chunk_length"],
        video_rates=tuple(raw["video_rates"]),
        network_info=network_info,
        network_split=raw["network_split"],
        video_split=raw["video_split"],
        user_split=raw["user_split"],
        qoe_split=raw["qoe_split"],
        trim_head=raw["trim_head"],
        trim_tail=raw["trim_tail"],
        frequency=raw["frequency"],
        sample_step=raw["sample_step"],
        startup_download=raw["startup_download"],
        max_size=float(raw["max_size"]),
        max_throughput=float(raw["max_throughput"]),
        past_k=raw["past_k"],
        action_space=raw["action_space"],
    )
