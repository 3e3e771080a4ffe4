"""The benchmark's plain reference: SO-Net in float32 PyTorch (``model``),
its training steps and eval forward (``train``), and the precision the
comparison's control runs in (``precision``).  It imports nothing of the
measured program and takes nothing it made: the benchmark hands both
sides the same weights, raw split and random seed."""
