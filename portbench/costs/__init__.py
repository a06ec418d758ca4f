"""The yardstick's arithmetic: the card's published peaks, the model
operations the inputs need (`model.py`) and the least time each measured
kernel could take on them (`kernels.py`). Every count is of live work:
tokens up to each row's [STOP], decode steps up to each row's own [STOP],
atom pairs of real atoms within the cutoff; so a program that skips padding
or dead rows raises a share and cannot push it past 100%."""

# one NVIDIA H100 SXM (data sheet; dense rates, at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
