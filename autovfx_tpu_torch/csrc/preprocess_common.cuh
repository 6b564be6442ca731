// What kernel 1 (preprocess.cu) and its backward (preprocess_bwd.cu)
// share: the constants of the projection and of the SH bands, and the
// layout of the camera parameter tensor (ops/preprocess_cuda.py
// `camera_params`).
#pragma once

namespace preprocess {

constexpr float kNearZ = 0.2f;
constexpr float kDilation = 0.3f;
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f;
constexpr float C2_1 = -1.0925484305920792f;
constexpr float C2_2 = 0.31539156525252005f;
constexpr float C2_3 = -1.0925484305920792f;
constexpr float C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f;
constexpr float C3_1 = 2.890611442640554f;
constexpr float C3_2 = -0.4570457994644658f;
constexpr float C3_3 = 0.3731763325901154f;
constexpr float C3_4 = -0.4570457994644658f;
constexpr float C3_5 = 1.445305721320277f;
constexpr float C3_6 = -0.5900435899266435f;

// layout of the camera parameter tensor (ops/preprocess_cuda.py)
constexpr int CAM_R = 0;       // 9, row-major w2c rotation
constexpr int CAM_T = 9;       // 3
constexpr int CAM_FX = 12;
constexpr int CAM_FY = 13;
constexpr int CAM_CX = 14;
constexpr int CAM_CY = 15;
constexpr int CAM_LIMX = 16;   // 1.3 * tan_half_fovx
constexpr int CAM_LIMY = 17;
constexpr int CAM_POS = 18;    // 3, camera center in world space

}  // namespace preprocess
