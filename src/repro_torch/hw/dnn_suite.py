"""The paper's Section VI benchmark workloads (AlexNet, ResNet34,
Inception, LSTM, GRU) as GEMM layer lists. Dimensions follow the
standard published architectures. The repo's own registry architectures
are mapped in ``repro_torch.hw.workload`` instead.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.hw.macro import GemmLayer, conv


def alexnet() -> List[GemmLayer]:
    return [
        conv("conv1", 55, 3, 11, 96),
        conv("conv2", 27, 96, 5, 256),
        conv("conv3", 13, 256, 3, 384),
        conv("conv4", 13, 384, 3, 384),
        conv("conv5", 13, 384, 3, 256),
        GemmLayer("fc6", 1, 9216, 4096),
        GemmLayer("fc7", 1, 4096, 4096),
        GemmLayer("fc8", 1, 4096, 1000),
    ]


def resnet34() -> List[GemmLayer]:
    layers = [conv("conv1", 112, 3, 7, 64)]
    stages = [(64, 3, 56), (128, 4, 28), (256, 6, 14), (512, 3, 7)]
    prev_c = 64
    for si, (c, blocks, hw) in enumerate(stages):
        for b in range(blocks):
            cin = prev_c if b == 0 else c
            layers.append(conv(f"s{si}b{b}c1", hw, cin, 3, c))
            layers.append(conv(f"s{si}b{b}c2", hw, c, 3, c))
            if b == 0 and cin != c:
                layers.append(conv(f"s{si}b{b}ds", hw, cin, 1, c))
        prev_c = c
    layers.append(GemmLayer("fc", 1, 512, 1000))
    return layers


def inception() -> List[GemmLayer]:
    """GoogLeNet(Inception-v1)-style workload: stem + 9 inception modules."""
    layers = [
        conv("stem1", 112, 3, 7, 64),
        conv("stem2", 56, 64, 3, 192),
    ]
    # (hw, c_in, [#1x1, #3x3red, #3x3, #5x5red, #5x5, pool_proj])
    modules = [
        (28, 192, (64, 96, 128, 16, 32, 32)),
        (28, 256, (128, 128, 192, 32, 96, 64)),
        (14, 480, (192, 96, 208, 16, 48, 64)),
        (14, 512, (160, 112, 224, 24, 64, 64)),
        (14, 512, (128, 128, 256, 24, 64, 64)),
        (14, 512, (112, 144, 288, 32, 64, 64)),
        (14, 528, (256, 160, 320, 32, 128, 128)),
        (7, 832, (256, 160, 320, 32, 128, 128)),
        (7, 832, (384, 192, 384, 48, 128, 128)),
    ]
    for i, (hw, cin, (c1, r3, c3, r5, c5, pp)) in enumerate(modules):
        layers += [
            conv(f"inc{i}_1x1", hw, cin, 1, c1),
            conv(f"inc{i}_3x3r", hw, cin, 1, r3),
            conv(f"inc{i}_3x3", hw, r3, 3, c3),
            conv(f"inc{i}_5x5r", hw, cin, 1, r5),
            conv(f"inc{i}_5x5", hw, r5, 5, c5),
            conv(f"inc{i}_pool", hw, cin, 1, pp),
        ]
    layers.append(GemmLayer("fc", 1, 1024, 1000))
    return layers


def lstm(hidden: int = 512, inp: int = 512, steps: int = 100) -> List[GemmLayer]:
    # 4 gates; input and recurrent GEMMs per step, batched over timesteps.
    return [
        GemmLayer("lstm_x", steps, inp, 4 * hidden),
        GemmLayer("lstm_h", steps, hidden, 4 * hidden),
        GemmLayer("proj", steps, hidden, inp),
    ]


def gru(hidden: int = 512, inp: int = 512, steps: int = 100) -> List[GemmLayer]:
    return [
        GemmLayer("gru_x", steps, inp, 3 * hidden),
        GemmLayer("gru_h", steps, hidden, 3 * hidden),
        GemmLayer("proj", steps, hidden, inp),
    ]


BENCHMARKS: Dict[str, List[GemmLayer]] = {}


def get_benchmarks() -> Dict[str, List[GemmLayer]]:
    if not BENCHMARKS:
        BENCHMARKS.update(
            AlexNet=alexnet(),
            ResNet34=resnet34(),
            Inception=inception(),
            LSTM=lstm(),
            GRU=gru(),
        )
    return BENCHMARKS
