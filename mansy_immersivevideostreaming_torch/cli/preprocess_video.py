"""Video preprocessing CLI: ffmpeg tiling + manifest generation.

Port of the JAX package's ``cli/preprocess_video.py`` (reference
``dataset_preprocess/video.py``): each bitrate version of a video is
segmented into 1 s chunks, each chunk cropped into the 8x8 tile grid
(tile_id = h * tile_num_height + w, reference ``video.py:34``), and the
per-tile file sizes and qualities (= bitrate) go into the manifest JSON
schema the simulator reads (reference ``video.py:123-152``).  The ffmpeg
work runs on the host, the bitrate versions in a thread pool (the
reference used a 5-process ``multiprocessing.Pool``, ``video.py:128``).
``main`` exits when ``ffmpeg`` is not on PATH.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import time

from mansy_immersivevideostreaming_torch.config import load_config


def _run_ffmpeg(cmd):
    result = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            universal_newlines=True)
    if result.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {' '.join(cmd)}\n{result.stderr}")


def segment_video_into_chunks(video_path, chunk_path, rate, start, duration):
    """Reference ``video.py:11-28``."""
    _run_ffmpeg(["ffmpeg", "-y", "-ss", f"{start}", "-t", f"{duration}",
                 "-accurate_seek", "-i", video_path, "-c:v", "libx264",
                 "-b:v", f"{rate}M", "-avoid_negative_ts", "1", chunk_path])


def crop_chunk_into_tiles(chunk_path, tile_path_fmt, rate, tile_res,
                          tile_num_width, tile_num_height):
    """Reference ``video.py:31-49`` (tile_id = h * tile_num_height + w)."""
    for h in range(tile_num_height):
        for w in range(tile_num_width):
            tile_id = h * tile_num_height + w
            _run_ffmpeg(["ffmpeg", "-y", "-i", chunk_path, "-vf",
                         f"crop={tile_res[0]}:{tile_res[1]}:"
                         f"{w * tile_res[0]}:{h * tile_res[1]}",
                         "-b:v", f"{rate}M", tile_path_fmt % tile_id])


def preprocess_video_one_rate(dataset, raw_video_dataset_dir, video, rate, config):
    """Profile one bitrate version; reference ``video.py:52-99``."""
    video_path = os.path.join(raw_video_dataset_dir, f"video{video}", f"{video}-{rate}M.mp4")
    tmp_dir = os.path.join(raw_video_dataset_dir, "tmp", f"video{video}", str(rate))
    os.makedirs(tmp_dir, exist_ok=True)
    video_length, video_width, video_height = config.video_info[dataset][video]
    tile_res = (video_width // config.tile_num_width, video_height // config.tile_num_height)

    chunk_info = {}
    for chunk_id in range(video_length // config.chunk_length):
        for fname in os.listdir(tmp_dir):
            if fname.endswith(".mp4"):
                os.remove(os.path.join(tmp_dir, fname))
        chunk_path = os.path.join(tmp_dir, f"{chunk_id}-{chunk_id + config.chunk_length}.mp4")
        segment_video_into_chunks(video_path, chunk_path, rate,
                                  start=chunk_id, duration=config.chunk_length)
        tile_path_fmt = os.path.join(
            tmp_dir, f"{chunk_id}-{chunk_id + config.chunk_length}-%d.mp4")
        crop_chunk_into_tiles(chunk_path, tile_path_fmt, rate, tile_res,
                              config.tile_num_width, config.tile_num_height)
        sizes = [os.path.getsize(tile_path_fmt % t) for t in range(config.tile_total_num)]
        chunk_info[chunk_id] = {"size": sizes, "quality": [rate] * config.tile_total_num}
        print(f"({video}, {rate}) Chunk #{chunk_id} done...")
    return rate, chunk_info


def preprocess_video(dataset, video, config, workers=5):
    """One video -> manifest JSON; reference ``video.py:102-154``."""
    raw_video_dataset_dir = os.path.join(config.raw_datasets_dir.get(
        dataset, os.path.join(config.datasets_base_dir, "raw", dataset)), "videos")
    manifest_dir = config.manifest_dir(dataset)
    os.makedirs(manifest_dir, exist_ok=True)

    video_length, _, _ = config.video_info[dataset][video]
    rates = sorted(config.video_rates)
    video_data = {
        "Video_Time": video_length,
        "Chunk_Count": video_length // config.chunk_length,
        "Chunk_Time": config.chunk_length,
        "Available_Bitrates": rates,
    }
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(preprocess_video_one_rate, dataset, raw_video_dataset_dir,
                               video, r, config)
                   for r in rates]
        per_rate = dict(f.result() for f in futures)

    chunks = {}
    for chunk_id in range(video_length // config.chunk_length):
        chunks[chunk_id] = {
            "size": [per_rate[r][chunk_id]["size"] for r in rates],
            "quality": [per_rate[r][chunk_id]["quality"] for r in rates],
        }
    video_data["Chunks"] = chunks
    manifest = os.path.join(manifest_dir, f"video{video}.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(video_data, f, ensure_ascii=False, indent=2)
    print(f"Manifest file of video {video} saved at {manifest} "
          f"({round((time.time() - t0) / 3600, 2)}h)")


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="Jin2022")
    parser.add_argument("--videos", type=int, nargs="*",
                        help="subset of video ids (default: all)")
    parser.add_argument("--workers", type=int, default=5)
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg binary not found on PATH — video "
                         "preprocessing requires ffmpeg (reference README:26)")
    config = load_config(args.config_yml)
    videos = args.videos or list(range(1, config.video_num[args.dataset] + 1))
    for video in videos:
        preprocess_video(args.dataset, video, config, args.workers)


if __name__ == "__main__":
    main()
