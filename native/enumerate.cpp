// Native state-space enumerator for prosper-tpu.
//
// The reference library is pure Python (SURVEY.md §2a: no native
// components), so this is the one place this build adds native code on
// the host side: enumerating the truncated latent-state space
// {states over Hp slots, min_active..gamma active, K non-zero values}
// explodes combinatorially for DSC/TSC configs (sum_k C(Hp,k) K^k can reach
// 10^5..10^7 states), and the itertools-based Python path becomes the
// dominant model-construction cost.  This C++ implementation fills the
// caller-allocated numpy buffers directly (see core/states.py for the
// ctypes binding and the always-available numpy fallback).
//
// Ordering contract (must match states.py exactly): by support size k,
// then lexicographic support combination, then lexicographic value
// assignment (base-K counting, first slot most significant).
//
// Build: cc -O2 -shared -fPIC -o libprosper_enum.so enumerate.cpp
//        (see native/build.sh; loaded via ctypes, no pybind11 needed)

#include <cstdint>
#include <vector>

extern "C" {

// Number of states: sum_{k=min_active}^{gamma} C(Hp,k) * K^k
// Returns -1 on overflow of int64.
int64_t prosper_enum_count(int32_t Hp, int32_t gamma, int32_t K,
                           int32_t min_active) {
    long double total = 0.0L;
    int64_t itotal = 0;
    for (int k = min_active; k <= gamma; ++k) {
        // C(Hp, k)
        long double c = 1.0L;
        for (int i = 0; i < k; ++i) c = c * (Hp - i) / (i + 1);
        long double kk = 1.0L;
        for (int i = 0; i < k; ++i) kk *= K;
        total += c * kk;
        if (total > 9.0e18L) return -1;
    }
    itotal = (int64_t)(total + 0.5L);
    return itotal;
}

// Fill states (S x Hp), value_counts (S x K), abs_states (S), outer
// (S x Hp*Hp), all float32, caller-allocated with S from
// prosper_enum_count.  values: (K) float32 non-zero latent values.
// Returns the number of states written (== S) or -1 on error.
int64_t prosper_enum_fill(int32_t Hp, int32_t gamma, int32_t K,
                          int32_t min_active, const float* values,
                          float* states, float* value_counts,
                          float* abs_states, float* outer) {
    if (Hp <= 0 || gamma < min_active || gamma > Hp || K <= 0) return -1;
    int64_t row = 0;
    std::vector<int32_t> support(gamma);
    std::vector<int32_t> assign(gamma);

    for (int k = min_active; k <= gamma; ++k) {
        // first combination 0,1,...,k-1
        for (int i = 0; i < k; ++i) support[i] = i;
        bool more_support = true;
        while (more_support) {
            // iterate all K^k assignments in lexicographic order
            for (int i = 0; i < k; ++i) assign[i] = 0;
            bool more_assign = true;
            while (more_assign) {
                float* srow = states + row * Hp;
                float* vrow = value_counts + row * K;
                for (int i = 0; i < Hp; ++i) srow[i] = 0.0f;
                for (int i = 0; i < K; ++i) vrow[i] = 0.0f;
                for (int i = 0; i < k; ++i) {
                    srow[support[i]] = values[assign[i]];
                    vrow[assign[i]] += 1.0f;
                }
                abs_states[row] = (float)k;
                float* orow = outer + row * Hp * Hp;
                for (int a = 0; a < Hp; ++a) {
                    const float sa = srow[a];
                    float* orow_a = orow + a * Hp;
                    if (sa == 0.0f) {
                        for (int b = 0; b < Hp; ++b) orow_a[b] = 0.0f;
                    } else {
                        for (int b = 0; b < Hp; ++b) orow_a[b] = sa * srow[b];
                    }
                }
                ++row;
                // next assignment (base-K counter, LAST slot fastest —
                // matches itertools.product)
                more_assign = false;
                for (int i = k - 1; i >= 0; --i) {
                    if (++assign[i] < K) { more_assign = true; break; }
                    assign[i] = 0;
                }
            }
            // next combination (standard lexicographic successor)
            more_support = false;
            for (int i = k - 1; i >= 0; --i) {
                if (support[i] < Hp - (k - i)) {
                    ++support[i];
                    for (int j = i + 1; j < k; ++j)
                        support[j] = support[j - 1] + 1;
                    more_support = true;
                    break;
                }
            }
        }
    }
    return row;
}

}  // extern "C"
