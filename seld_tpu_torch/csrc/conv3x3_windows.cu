// K10b: the CNN-frontend stage as nine per-tap products summed over Cin,
// for any Cin.
//
// Replaces seld_tpu/ops/pallas/conv2d_pool.py:749
//   conv2d_bn_relu_fpool (kernel body _kernel, :55).
// Contract: x (B, Cin, F, T), w (3, 3, Cin, Cout), scale/bias (Cout,) float
// -> out (B, Cout, F/pf, T) with out = max_r relu(conv(x)[f*pf + r] * scale
// + bias); zero padding 1, T not pooled; any Cin >= 1, any T, any pf that
// divides F.
//
// What bounds it on the H100: arithmetic, 2 * 9 * Cin * Cout operations per
// output pixel against x + w + out bytes (at the flagship's stage 2, 20.4
// GFLOP against 44 MB at batch 2 in bf16).
// Design: the TPU kernel read pre-packed overlapping windows because Mosaic
// cannot DMA a halo slice; here each block stages its halo straight from x,
// with the conv's zero padding written at the F and T borders, so no packed
// copy exists. That is K3's kernel body (conv3x3_bn_relu_fpool.cu: the
// block tile, 4 conv rows a pass, Cin walked in chunks of 16 in bfloat16 and
// of 8 in float32's split TF32): its staging zero-fills the channels of a
// ragged last chunk, so the same kernel takes any Cin, and this entry point
// launches it under K10b's own name and launch count. K5's bfloat16 forward
// (F2) launches it too, for Cin <= 10: its
// rows are then those of K5's F1 and g_z passes (conv3x3_train.cu).

extern "C" int seld_conv3x3_widecin(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int batch, int cin,
                                    int f_dim, int t_dim, int cout, int pf, int dtype,
                                    void* stream);

// Any Cin: Cin walked in chunks, the last one ragged.
extern "C" int seld_conv3x3_windows(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int batch, int cin,
                                    int f_dim, int t_dim, int cout, int pf, int dtype,
                                    void* stream) {
  return seld_conv3x3_widecin(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf,
                              dtype, stream);
}
