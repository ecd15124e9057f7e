"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W): the yardstick of every roofline and mfu metric.  The
integer rate is 64 lanes x 132 SMs x 1.98 GHz."""

F32 = 67e12          # float32 outside the tensor cores, operations/s
TF32 = 494.7e12      # TF32 on the tensor cores, operations/s
BF16 = 989e12        # bf16 on the tensor cores, operations/s
INT32 = 16.7e12      # 32-bit integer operations/s
HBM = 3.35e12        # bytes/s
