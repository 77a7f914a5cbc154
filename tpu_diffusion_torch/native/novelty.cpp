// Novelty scoring kernels: Kabsch RMSD, TM-score, GDT-TS, and the
// brute-force closest-structure scan over a training set.
//
// Native C++ replacement for the reference's Cython Kabsch/RMSD
// (src/evaluation/novelty/novelty_calculation_cython.pyx:6-25) and numba
// TM/GDT + find_closest_structure (novelty_calculation.py:7-120). The scan
// is O(n_samples * n_train * windows * N) — the evaluation pipeline's CPU
// hot spot — so it lives in C++ with the alignment inlined (Horn's
// quaternion method: the optimal *proper* rotation, equivalent to Kabsch
// with the determinant sign fix).
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

namespace {

// Largest-eigenvalue eigenvector of a symmetric 4x4 matrix via Jacobi.
void jacobi4(double a[4][4], double v[4][4]) {
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) v[i][j] = (i == j) ? 1.0 : 0.0;
    for (int sweep = 0; sweep < 64; ++sweep) {
        double off = 0.0;
        for (int p = 0; p < 4; ++p)
            for (int q = p + 1; q < 4; ++q) off += a[p][q] * a[p][q];
        if (off < 1e-24) break;
        for (int p = 0; p < 4; ++p) {
            for (int q = p + 1; q < 4; ++q) {
                if (std::fabs(a[p][q]) < 1e-18) continue;
                double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
                double t = (theta >= 0 ? 1.0 : -1.0) /
                           (std::fabs(theta) + std::sqrt(theta * theta + 1));
                double c = 1.0 / std::sqrt(t * t + 1), s = t * c;
                for (int k = 0; k < 4; ++k) {
                    double akp = a[k][p], akq = a[k][q];
                    a[k][p] = c * akp - s * akq;
                    a[k][q] = s * akp + c * akq;
                }
                for (int k = 0; k < 4; ++k) {
                    double apk = a[p][k], aqk = a[q][k];
                    a[p][k] = c * apk - s * aqk;
                    a[q][k] = s * apk + c * aqk;
                }
                for (int k = 0; k < 4; ++k) {
                    double vkp = v[k][p], vkq = v[k][q];
                    v[k][p] = c * vkp - s * vkq;
                    v[k][q] = s * vkp + c * vkq;
                }
            }
        }
    }
}

// Optimal proper rotation R aligning centered P onto centered Q (Horn 1987).
void horn_rotation(const double c[3][3], double r[3][3]) {
    double sxx = c[0][0], sxy = c[0][1], sxz = c[0][2];
    double syx = c[1][0], syy = c[1][1], syz = c[1][2];
    double szx = c[2][0], szy = c[2][1], szz = c[2][2];
    double n[4][4] = {
        {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
        {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
        {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
        {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz}};
    double vecs[4][4];
    jacobi4(n, vecs);
    // column with the largest eigenvalue (diagonal of rotated n)
    int best = 0;
    double best_val = n[0][0];
    for (int i = 1; i < 4; ++i)
        if (n[i][i] > best_val) { best_val = n[i][i]; best = i; }
    double q0 = vecs[0][best], q1 = vecs[1][best], q2 = vecs[2][best],
           q3 = vecs[3][best];
    double norm = std::sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
    q0 /= norm; q1 /= norm; q2 /= norm; q3 /= norm;
    r[0][0] = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3;
    r[0][1] = 2 * (q1 * q2 - q0 * q3);
    r[0][2] = 2 * (q1 * q3 + q0 * q2);
    r[1][0] = 2 * (q1 * q2 + q0 * q3);
    r[1][1] = q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3;
    r[1][2] = 2 * (q2 * q3 - q0 * q1);
    r[2][0] = 2 * (q1 * q3 - q0 * q2);
    r[2][1] = 2 * (q2 * q3 + q0 * q1);
    r[2][2] = q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3;
}

// Align P (n x 3) onto Q; writes aligned coordinates into out.
void align_impl(const double* p, const double* q, int64_t n, double* out) {
    double mp[3] = {0, 0, 0}, mq[3] = {0, 0, 0};
    for (int64_t i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            mp[d] += p[3 * i + d];
            mq[d] += q[3 * i + d];
        }
    for (int d = 0; d < 3; ++d) { mp[d] /= n; mq[d] /= n; }
    double c[3][3] = {{0}};
    for (int64_t i = 0; i < n; ++i) {
        double pc[3], qc[3];
        for (int d = 0; d < 3; ++d) {
            pc[d] = p[3 * i + d] - mp[d];
            qc[d] = q[3 * i + d] - mq[d];
        }
        for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b) c[a][b] += pc[a] * qc[b];
    }
    double r[3][3];
    horn_rotation(c, r);
    // out_i = R^T pc_i + mq  (R maps P->Q frame; aligned P in Q's frame)
    for (int64_t i = 0; i < n; ++i) {
        double pc[3];
        for (int d = 0; d < 3; ++d) pc[d] = p[3 * i + d] - mp[d];
        for (int d = 0; d < 3; ++d)
            out[3 * i + d] =
                r[d][0] * pc[0] + r[d][1] * pc[1] + r[d][2] * pc[2] + mq[d];
    }
}

// sqrt(mean over all 3n entries) — the reference's rmsd definition
// (novelty_calculation_cython.pyx:23-25 uses np.mean over the 2-D array).
double rmsd_impl(const double* p, const double* q, int64_t n) {
    double acc = 0.0;
    for (int64_t i = 0; i < 3 * n; ++i) {
        double d = p[i] - q[i];
        acc += d * d;
    }
    return std::sqrt(acc / (3.0 * n));
}

double tm_impl(const double* p, const double* q, int64_t n) {
    // Zhang & Skolnick d0, clamped at 0.5 (standard TM-score floor):
    // the raw formula is <= 0 for n <= 18 and would blow up the ratio.
    double d0 = std::max(1.24 * std::cbrt((double)n - 15.0) - 1.8, 0.5);
    double acc = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double dd = 0.0;
        for (int d = 0; d < 3; ++d) {
            double diff = p[3 * i + d] - q[3 * i + d];
            dd += diff * diff;
        }
        double ratio = std::sqrt(dd) / d0;
        acc += 1.0 / (1.0 + ratio * ratio);
    }
    return acc / n;
}

double gdt_impl(const double* p, const double* q, int64_t n) {
    const double thresholds[4] = {1.0, 2.0, 4.0, 8.0};
    // min distance from each p_i to any q_j (the reference takes
    // (dist < t).max(axis=1) over the full n x n matrix)
    double score = 0.0;
    for (int ti = 0; ti < 4; ++ti) {
        double t2 = thresholds[ti] * thresholds[ti];
        int64_t hits = 0;
        for (int64_t i = 0; i < n; ++i) {
            for (int64_t j = 0; j < n; ++j) {
                double dd = 0.0;
                for (int d = 0; d < 3; ++d) {
                    double diff = p[3 * i + d] - q[3 * j + d];
                    dd += diff * diff;
                }
                if (dd < t2) { hits++; break; }
            }
        }
        score += (double)hits / n;
    }
    return score / 4.0;
}

}  // namespace

extern "C" {

void nov_kabsch_align(const double* p, const double* q, int64_t n,
                      double* out) {
    align_impl(p, q, n, out);
}

double nov_rmsd(const double* p, const double* q, int64_t n) {
    return rmsd_impl(p, q, n);
}

double nov_kabsch_rmsd(const double* p, const double* q, int64_t n,
                       double* scratch) {
    align_impl(p, q, n, scratch);
    return rmsd_impl(scratch, q, n);
}

double nov_tm_score(const double* p, const double* q, int64_t n) {
    return tm_impl(p, q, n);
}

double nov_gdt_score(const double* p, const double* q, int64_t n) {
    return gdt_impl(p, q, n);
}

// Brute-force closest-structure scan with the reference's sliding-window
// rule for unequal lengths (novelty_calculation.py:60-113).
// train_flat: concatenated [sum(len_i) x 3]; offsets[i]..offsets[i+1] rows.
// out_metrics = {best_rmsd, best_tm, best_gdt};
// out_match   = {train_idx * 100000 + window} per metric (-1 if none).
void nov_find_closest(const double* query, int64_t nq,
                      const double* train_flat, const int64_t* offsets,
                      int64_t n_train, double* scratch /* >= 3*nq */,
                      double* out_metrics, int64_t* out_match) {
    double best_rmsd = std::numeric_limits<double>::infinity();
    double best_tm = -std::numeric_limits<double>::infinity();
    double best_gdt = -std::numeric_limits<double>::infinity();
    int64_t id_rmsd = -1, id_tm = -1, id_gdt = -1;

    for (int64_t s = 0; s < n_train; ++s) {
        const double* sample = train_flat + 3 * offsets[s];
        int64_t ns = offsets[s + 1] - offsets[s];
        int64_t n = nq < ns ? nq : ns;
        int64_t windows = (nq == ns) ? 1
                          : (nq < ns ? ns - nq : nq - ns);
        for (int64_t wdw = 0; wdw < windows; ++wdw) {
            const double* pw = (nq > ns) ? query + 3 * wdw : query;
            const double* qw = (nq < ns) ? sample + 3 * wdw : sample;
            align_impl(pw, qw, n, scratch);
            double r = rmsd_impl(scratch, qw, n);
            double tm = tm_impl(scratch, qw, n);
            double gdt = gdt_impl(scratch, qw, n);
            int64_t code = s * 100000 + wdw;
            if (r < best_rmsd) { best_rmsd = r; id_rmsd = code; }
            if (tm > best_tm) { best_tm = tm; id_tm = code; }
            if (gdt > best_gdt) { best_gdt = gdt; id_gdt = code; }
        }
    }
    out_metrics[0] = best_rmsd;
    out_metrics[1] = best_tm;
    out_metrics[2] = best_gdt;
    out_match[0] = id_rmsd;
    out_match[1] = id_tm;
    out_match[2] = id_gdt;
}

}  // extern "C"
