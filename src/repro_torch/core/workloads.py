"""Benchmark workload definitions: ResNet-18 and MobileNetV1 layer shapes
(224x224 ImageNet), lowered to im2col GEMMs for the cycle simulator.

These mirror the SCALE-Sim topology files the paper used (Section V-C).
A copy of the JAX package's ``core/workloads.py``.
"""

from __future__ import annotations

from typing import List

from .simulator import Gemm, conv2d_gemm

__all__ = ["resnet18_gemms", "mobilenetv1_gemms"]


def resnet18_gemms() -> List[Gemm]:
    """ResNet-18, 224x224 input.  (out_h, out_w, in_ch, out_ch, k)."""
    layers = [
        # conv1: 7x7/2
        (112, 112, 3, 64, 7),
        # layer1: 2 blocks of [3x3 64 -> 3x3 64] @ 56
        (56, 56, 64, 64, 3), (56, 56, 64, 64, 3),
        (56, 56, 64, 64, 3), (56, 56, 64, 64, 3),
        # layer2: downsample block + identity block @ 28
        (28, 28, 64, 128, 3), (28, 28, 128, 128, 3), (28, 28, 64, 128, 1),
        (28, 28, 128, 128, 3), (28, 28, 128, 128, 3),
        # layer3 @ 14
        (14, 14, 128, 256, 3), (14, 14, 256, 256, 3), (14, 14, 128, 256, 1),
        (14, 14, 256, 256, 3), (14, 14, 256, 256, 3),
        # layer4 @ 7
        (7, 7, 256, 512, 3), (7, 7, 512, 512, 3), (7, 7, 256, 512, 1),
        (7, 7, 512, 512, 3), (7, 7, 512, 512, 3),
    ]
    gemms: List[Gemm] = []
    for i, (oh, ow, ic, oc, k) in enumerate(layers):
        gemms += conv2d_gemm(oh, ow, ic, oc, k, k, name=f"conv{i}")
    # final FC 512 -> 1000
    gemms.append(Gemm(B=1, K=512, C=1000, name="fc"))
    return gemms


def mobilenetv1_gemms() -> List[Gemm]:
    """MobileNetV1 1.0x, 224x224.  Depthwise layers lower to grouped GEMMs,
    but a 3x3 depthwise GEMM is K=9, C=1 per group — the paper (and
    SCALE-Sim) fold them as (out_pixels, 9, channels) depthwise blocks; we
    model each depthwise conv as one GEMM with K=9 and C=channels, which
    matches how a WS array processes channel-parallel depthwise filters.
    """
    # (out_hw, in_ch, out_ch, k, depthwise)
    layers = [
        (112, 3, 32, 3, False),
        (112, 32, 32, 3, True), (112, 32, 64, 1, False),
        (56, 64, 64, 3, True), (56, 64, 128, 1, False),
        (56, 128, 128, 3, True), (56, 128, 128, 1, False),
        (28, 128, 128, 3, True), (28, 128, 256, 1, False),
        (28, 256, 256, 3, True), (28, 256, 256, 1, False),
        (14, 256, 256, 3, True), (14, 256, 512, 1, False),
        # 5x repeated 512 dw+pw blocks @ 14
        (14, 512, 512, 3, True), (14, 512, 512, 1, False),
        (14, 512, 512, 3, True), (14, 512, 512, 1, False),
        (14, 512, 512, 3, True), (14, 512, 512, 1, False),
        (14, 512, 512, 3, True), (14, 512, 512, 1, False),
        (14, 512, 512, 3, True), (14, 512, 512, 1, False),
        (7, 512, 512, 3, True), (7, 512, 1024, 1, False),
        (7, 1024, 1024, 3, True), (7, 1024, 1024, 1, False),
    ]
    gemms: List[Gemm] = []
    for i, (hw, ic, oc, k, dw) in enumerate(layers):
        if dw:
            gemms.append(Gemm(B=hw * hw, K=k * k, C=oc, name=f"dw{i}"))
        else:
            gemms += conv2d_gemm(hw, hw, ic, oc, k, k, name=f"conv{i}")
    gemms.append(Gemm(B=1, K=1024, C=1000, name="fc"))
    return gemms
