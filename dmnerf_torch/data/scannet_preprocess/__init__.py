# Ported from dmnerf_tpu/data/scannet_preprocess/__init__.py (the package holds the same four modules, on utils/jpeg.py and utils/png.py in place of imageio and cv2).
"""ScanNet's offline pipeline: .sens export (sensordata), label remap
(preprocess), train/test split (split), and its CLI (run)."""
