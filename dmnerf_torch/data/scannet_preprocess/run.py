# Ported from dmnerf_tpu/data/scannet_preprocess/run.py (the port's sensordata, preprocess and split modules; each stage also prints its seconds).
"""ScanNet preprocessing CLI.

Mirrors the reference's offline pipeline (preprocess.py __main__ + split.py
__main__): .sens export -> label/instance remap -> even train/test split.

    python -m dmnerf_torch.data.scannet_preprocess.run \
        --scans ./scans --out ./selected_scenes \
        --label_map ./scannetv2-labels.combined.tsv \
        --save_dir ./data/scannet --frames 300
"""

from __future__ import annotations

import argparse
import glob
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", required=True, help="folder of raw scene dirs with .sens")
    ap.add_argument("--out", required=True, help="unzip/export folder")
    ap.add_argument("--label_map", required=True, help="scannetv2-labels.combined.tsv")
    ap.add_argument("--save_dir", required=True, help="final split output folder")
    ap.add_argument("--frames", type=int, default=300, help="target frames per split")
    args = ap.parse_args(argv)

    from dmnerf_torch.data.scannet_preprocess.preprocess import preprocess_scene
    from dmnerf_torch.data.scannet_preprocess.sensordata import SensorData
    from dmnerf_torch.data.scannet_preprocess.split import split_evenly

    scenes = sorted(d for d in os.listdir(args.scans)
                    if len(d) >= len("scene0000_00"))
    for scene in scenes:
        sens = os.path.join(args.scans, scene, f"{scene}.sens")
        out_dir = os.path.join(args.out, scene)
        if os.path.exists(sens) and not os.path.exists(os.path.join(out_dir, "color")):
            print(f"exporting {scene} ...")
            t0, sd = time.perf_counter(), SensorData(sens)
            sd.export_all(out_dir)
            print(f"exported {sd.num_frames} frames in {time.perf_counter() - t0:.3f} s",
                  flush=True)
        print(f"remapping labels for {scene} ...")
        t0 = time.perf_counter()
        n = preprocess_scene(out_dir, args.label_map)
        print(f"remapped {n} frames in {time.perf_counter() - t0:.3f} s", flush=True)

    for scene_dir in sorted(glob.glob(os.path.join(args.out, "*_*"))):
        print(f"splitting {scene_dir} ...")
        t0 = time.perf_counter()
        train_ids, test_ids = split_evenly(scene_dir, args.save_dir, args.frames)
        print(f"split {len(train_ids)} train and {len(test_ids)} test frames in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


if __name__ == "__main__":
    main()
