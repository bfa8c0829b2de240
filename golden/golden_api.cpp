// C ABI around the REFERENCE engine compiled from
// /root/reference/src/core (see golden/README.md): the public
// ISyncProblem surface plus hooks into the deterministic internals
// (opt_compute_problem, FrameState::Loss, ndspline eval) so the JAX
// rebuild can be checked against true reference tensors, not a
// reimplemented oracle. Ref: src/core/core_private.cpp:15-32 (P),
// :92-133 (Loss), :61-90/:205-361 (PreSync/Sync/DebugPreSync).

#include <core_private.hpp>

#include <cmath>
#include <cstdint>
#include <vector>

#include <quat.hpp>

// defined in the reference's core_private.cpp (external linkage, no
// declaration in the header)
arma::mat opt_compute_problem(int64_t frame, double gyro_delay, const OptData& data);

extern "C" {

void* golden_create() { return new SyncProblemPrivate(); }

void golden_destroy(void* p) { delete static_cast<SyncProblemPrivate*>(p); }

void golden_set_gyro_fixed(void* p, const double* data, size_t count,
                           double sample_rate, double first_ts) {
    static_cast<SyncProblemPrivate*>(p)->SetGyroQuaternions(data, count, sample_rate,
                                                            first_ts);
}

void golden_set_gyro_us(void* p, const int64_t* ts_us, const double* quats,
                        size_t count) {
    static_cast<SyncProblemPrivate*>(p)->SetGyroQuaternions(ts_us, quats, count);
}

void golden_set_track(void* p, int64_t frame, const double* ts_a, const double* ts_b,
                      const double* rays_a, const double* rays_b, size_t count) {
    static_cast<SyncProblemPrivate*>(p)->SetTrackResult(frame, ts_a, ts_b, rays_a,
                                                        rays_b, count);
}

void golden_presync(void* p, double initial, int64_t fb, int64_t fe, double step,
                    double radius, double* out_cost, double* out_delay) {
    auto [c, d] = static_cast<SyncProblemPrivate*>(p)->PreSync(initial, fb, fe, step,
                                                               radius);
    *out_cost = c;
    *out_delay = d;
}

void golden_sync(void* p, double initial, int64_t fb, int64_t fe, double center,
                 double radius, double* out_cost, double* out_delay) {
    auto [c, d] =
        static_cast<SyncProblemPrivate*>(p)->Sync(initial, fb, fe, center, radius);
    *out_cost = c;
    *out_delay = d;
}

void golden_debug_presync(void* p, double initial, int64_t fb, int64_t fe,
                          double radius, double* delays, double* costs, int n) {
    static_cast<SyncProblemPrivate*>(p)->DebugPreSync(initial, fb, fe, radius, delays,
                                                      costs, n);
}

// ---- deterministic internals (no RANSAC involved) -------------------------

// P matrix for one frame at one delay; out is row-major (count x 3).
// Returns the row count (= feature count of the frame).
int golden_compute_problem(void* p, int64_t frame, double delay, double* out) {
    auto& problem = static_cast<SyncProblemPrivate*>(p)->problem;
    arma::mat P = opt_compute_problem(frame, delay, problem);
    for (size_t r = 0; r < P.n_rows; ++r)
        for (size_t c = 0; c < 3; ++c) out[r * 3 + c] = P(r, c);
    return static_cast<int>(P.n_rows);
}

// Full per-frame loss + jacobians at (delay, M, var_k)
// (ref core_private.cpp:92-115). motion_jac is the 1x3 row.
void golden_frame_loss(void* p, int64_t frame, double delay, const double* M3,
                       double var_k, double* loss, double* delay_grad,
                       double* motion_jac) {
    auto& problem = static_cast<SyncProblemPrivate*>(p)->problem;
    FrameState fs(frame, &problem);
    fs.var_k = var_k;
    arma::mat gyro_delay(1, 1);
    gyro_delay[0] = delay;
    arma::mat M(3, 1);
    for (int i = 0; i < 3; ++i) M[i] = M3[i];
    arma::mat l, jd, jm;
    fs.Loss(gyro_delay, M, l, jd, jm);
    *loss = l[0];
    *delay_grad = jd[0];
    for (int i = 0; i < 3; ++i) motion_jac[i] = jm[i];
}

// Simple (loss-only) overload (ref core_private.cpp:117-123).
double golden_frame_loss_simple(void* p, int64_t frame, double delay,
                                const double* M3, double var_k) {
    auto& problem = static_cast<SyncProblemPrivate*>(p)->problem;
    FrameState fs(frame, &problem);
    fs.var_k = var_k;
    arma::mat gyro_delay(1, 1);
    gyro_delay[0] = delay;
    arma::mat M(3, 1);
    for (int i = 0; i < 3; ++i) M[i] = M3[i];
    arma::mat l;
    fs.Loss(gyro_delay, M, l);
    return l[0];
}

// Raw (unnormalized) quat-spline sample at spline index t
// (ref ndspline.cpp:21-27 / minispline.cpp:48-55).
void golden_spline_eval(void* p, double t, double* out4) {
    auto& problem = static_cast<SyncProblemPrivate*>(p)->problem;
    arma::mat q = problem.quats.eval(t);
    for (int i = 0; i < 4; ++i) out4[i] = q[i];
}

// The reference driver's disabled fixed-rate intake path
// (core_testcode.cpp:20-35, the `#if 0` branch): gyro_interpolate
// resample, fixed-dt quaternion integration with the reference's own
// quat_from_aa/quat_prod, then the fixed-rate SetGyroQuaternions
// overload. The resample mirrors signal.cpp:62-85 over raw arrays
// (the shim armadillo has no interp1; arma::interp1's default is
// plain linear interpolation and the query grid lies strictly inside
// [front, back), so the semantics are unambiguous). ts: (n,) seconds;
// gyro: (n, 3) rad/s row-major. Returns the rounded sample rate;
// *out_first_ts = the resampled grid's first timestamp.
int golden_fill_gyro_interp(void* p, const double* ts, const double* gyro,
                            size_t n, double* out_first_ts) {
    // --- gyro_interpolate (signal.cpp:62-85) ---
    double actual_sr = double(n) / (ts[n - 1] - ts[0]);
    int rounded_sr = int(std::round(actual_sr / 50) * 50);
    std::vector<double> nts;
    for (double sample = std::ceil(ts[0] * rounded_sr);
         sample / rounded_sr < ts[n - 1]; sample += 1)
        nts.push_back(sample / rounded_sr);
    size_t m = nts.size();
    std::vector<double> ng(3 * m);  // column r of sample j at ng[3*j+r]
    size_t k = 0;
    for (size_t j = 0; j < m; ++j) {
        double t = nts[j];
        while (k + 2 < n && ts[k + 1] <= t) ++k;
        double w = (t - ts[k]) / (ts[k + 1] - ts[k]);
        for (int r = 0; r < 3; ++r)
            ng[3 * j + r] =
                gyro[3 * k + r] + w * (gyro[3 * (k + 1) + r] - gyro[3 * k + r]);
    }
    // --- fixed-dt integration (core_testcode.cpp:27-33) ---
    double sample_rate = rounded_sr;
    arma::mat quats(4, m);
    // (the driver writes `quats.col(0) = {1, 0, 0, 0}`; the shim's
    // initializer-list mat is 1x4, so spell out the column)
    for (int r = 0; r < 4; ++r) quats.at(r, 0) = r == 0 ? 1.0 : 0.0;
    for (size_t i = 1; i < m; ++i) {
        arma::vec3 aa;
        for (int r = 0; r < 3; ++r) aa[r] = ng[3 * i + r] / sample_rate;
        quats.col(i) = arma::normalise(quat_prod(quat_from_aa(aa), quats.col(i - 1)));
    }
    static_cast<SyncProblemPrivate*>(p)->SetGyroQuaternions(quats.mem.data(), m, sample_rate,
                                                            nts.front());
    *out_first_ts = nts.front();
    return rounded_sr;
}

double golden_sample_rate(void* p) {
    return static_cast<SyncProblemPrivate*>(p)->problem.sample_rate;
}

double golden_quats_start(void* p) {
    return static_cast<SyncProblemPrivate*>(p)->problem.quats_start;
}

}  // extern "C"
