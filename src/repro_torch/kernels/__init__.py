"""Hand-written Hopper kernels for the binarized hot path, with their
plain torch versions.

  packed.py         PackedArray (the canonical 1-bit layout, int32
                    words) + the backend registry ("cuda" | "torch")
  ref.py            plain torch oracles (the exactness targets)
  pack.py           sign + bit-pack activations      (csrc/pack.cu)
  xnor_gemm.py      float activations x packed weights, float32 sum,
                    alpha and threshold->pack epilogue (csrc/xnor_gemm.cu)
  popcount_gemm.py  both operands packed, XNOR-popcount GEMM with the
                    threshold->pack epilogue        (csrc/popcount_gemm.cu)
  packed_conv.py    im2col-free binary conv2d on channel-packed NHWC
                    words (+ word-level im2col)     (csrc/packed_conv.cu)
  fused_mlp.py      a thresholded binary-MLP stack in one launch,
                    activations kept in shared memory (csrc/fused_mlp.cu)
  entry_conv.py     the float entry conv (float32 FMAs) with its signs,
                    alpha taken in, packed in the epilogue
                    (csrc/entry_conv.cu); ``sign_weight_conv``
  residual.py       ReActNet and Bi-Real Net: a residual half-step in
                    one launch, the binary conv with its epilogue
                    (zero-pad correction, BN, shortcut, RPReLU, the
                    next sign's bits) on the tile (csrc/packed_conv.cu),
                    the real stem conv with its BN, max pool and signs
                    (csrc/stem_conv.cu), and the projection shortcut
                    (csrc/shortcut_conv.cu)
  ops.py            public wrappers, dispatch through the registry
  _build.py         nvcc build, ctypes binding and launch counts
  csrc/binary.cuh   device helpers: threshold modes, ballot pack
  csrc/b1_mma.cuh   cp.async, ldmatrix and the b1 AND-popcount mma.sync
  csrc/residual.cuh a residual half-step's float epilogue, on the
                    fused kernel's tile

No module builds or loads a kernel when it is imported: the libraries
are compiled on first launch.
"""
from repro_torch.kernels.fused_mlp import fused_binary_mlp
from repro_torch.kernels.ops import (binarize_pack, binary_binary_dense,
                                     binary_conv2d, binary_dense)
from repro_torch.kernels.packed import (BackendSpec, PackedArray,
                                        default_backend, get_backend,
                                        register_backend)

__all__ = ["BackendSpec", "PackedArray", "binarize_pack",
           "binary_binary_dense", "binary_conv2d", "binary_dense",
           "default_backend", "fused_binary_mlp", "get_backend",
           "register_backend"]
