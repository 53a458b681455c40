"""The plain reference that decides `correct`: `popref/`, a frozen copy of
the port's main-path modules as plain PyTorch and NumPy (no kernel, no
native library, no registered op; attention as einsum and softmax), run in
float32 with TF32 off; `build.py` builds it from a configuration file and
the benchmark's weights; `compare.py` reads the gaps between what the
timed path produced and what the reference computes from the same inputs;
`control.py` is the control: the reference one precision step lower."""
