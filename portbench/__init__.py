"""The benchmark of ``tpugan_torch``, the PyTorch and CUDA port: run one
cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``)."""
