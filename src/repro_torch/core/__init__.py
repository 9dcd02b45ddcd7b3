# OpenACM's compiler semantics and the GEMM dispatch engine (torch).
