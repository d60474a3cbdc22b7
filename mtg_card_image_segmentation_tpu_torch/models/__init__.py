"""MobileNetV3-Large + LR-ASPP segmentation model (NHWC at the public API)."""
