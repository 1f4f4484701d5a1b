// Levenshtein distance / operations / aggregate edit-statistics engine.
//
// Native equivalent of the reference's Rust pyo3 edit-distance module
// (the reference's src/edit_distance.rs). The observable semantics — DP
// recurrence, the first-row/first-column cost quirks, and the backtrace
// tie-break rules (prefer substitution/match when substitution <= min(del, ins);
// deletion wins over insertion only when strictly smaller; trailing prefix at
// cost 0 counted as correct) — are preserved exactly, because they determine the
// published PER/AER numbers. Unlike the reference, weighted substitution costs
// are passed in as a precomputed matrix (the Python layer vectorizes the
// feature-table hamming distances with numpy) instead of a per-cell Python
// callback, removing the FFI round trip from the inner loop.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

enum Action : int8_t { kInsertion = 0, kDeletion = 1, kSubstitution = 2, kMatch = -1 };

// Full DP matrix with the reference's cost conventions:
//   matrix[0][j] = j (unit insertion steps on the first row)
//   matrix[i][0] = matrix[i-1][0] + deletion_cost
//   cell = min(above + del, left + ins, diag + sub(a_i, b_j))
// `sub_costs` is row-major (m x n) or null for uniform 0/1 equality costs on the
// id sequences.
std::vector<float> full_matrix(const int32_t* seq_a, int32_t m, const int32_t* seq_b, int32_t n,
                               const float* sub_costs, float insertion_cost, float deletion_cost) {
    std::vector<float> matrix(static_cast<size_t>(m + 1) * (n + 1));
    for (int32_t j = 0; j <= n; ++j) matrix[j] = static_cast<float>(j);
    for (int32_t i = 1; i <= m; ++i) {
        float* row = &matrix[static_cast<size_t>(i) * (n + 1)];
        const float* prev = &matrix[static_cast<size_t>(i - 1) * (n + 1)];
        row[0] = prev[0] + deletion_cost;
        const float* cost_row = sub_costs ? &sub_costs[static_cast<size_t>(i - 1) * n] : nullptr;
        for (int32_t j = 1; j <= n; ++j) {
            float deletion = prev[j] + deletion_cost;
            float insertion = row[j - 1] + insertion_cost;
            float sub_cost = cost_row ? cost_row[j - 1]
                                      : (seq_a[i - 1] != seq_b[j - 1] ? 1.0f : 0.0f);
            float substitution = prev[j - 1] + sub_cost;
            row[j] = std::min(std::min(deletion, insertion), substitution);
        }
    }
    return matrix;
}

// Backtrace one best path using the reference's exact tie-break order. Invokes
// `emit(action, i, j)` for every step, where (i, j) is the coordinate *after*
// moving (matching the reference's operation coordinates). kMatch steps are
// emitted so callers can count correct symbols.
template <typename Emit>
void backtrace(const std::vector<float>& matrix, int32_t m, int32_t n, Emit emit) {
    const auto at = [&](int32_t i, int32_t j) -> float {
        return matrix[static_cast<size_t>(i) * (n + 1) + j];
    };
    float current_cost = at(m, n);
    int32_t i = m;
    int32_t j = n;
    while (current_cost != 0.0f) {
        Action action;
        float cost;
        if (i == 0) {
            if (j == 0) break;
            action = kInsertion;
            cost = at(i, j - 1);
        } else if (j == 0) {
            action = kDeletion;
            cost = at(i - 1, j);
        } else {
            float deletion = at(i - 1, j);
            float insertion = at(i, j - 1);
            float substitution = at(i - 1, j - 1);
            if (deletion < insertion) {
                action = kDeletion;
                cost = deletion;
            } else {
                action = kInsertion;
                cost = insertion;
            }
            if (substitution <= cost) {
                action = (substitution == current_cost) ? kMatch : kSubstitution;
                cost = substitution;
            }
        }
        current_cost = cost;
        switch (action) {
            case kMatch:
            case kSubstitution:
                --i;
                --j;
                break;
            case kDeletion:
                --i;
                break;
            case kInsertion:
                --j;
                break;
        }
        emit(action, i, j);
    }
    // Remaining prefix on the diagonal at zero cost is all matches.
    for (int32_t remaining = 0; remaining < i; ++remaining) emit(kMatch, -1, -1);
}

}  // namespace

extern "C" {

// Plain Levenshtein distance with uniform costs (two-row DP).
int64_t allophant_lev_distance(const int32_t* seq_a, int32_t m, const int32_t* seq_b, int32_t n) {
    std::vector<int64_t> previous(n + 1);
    std::vector<int64_t> current(n + 1);
    for (int32_t j = 0; j <= n; ++j) previous[j] = j;
    for (int32_t i = 0; i < m; ++i) {
        current[0] = i + 1;
        for (int32_t j = 0; j < n; ++j) {
            int64_t deletion = previous[j + 1] + 1;
            int64_t insertion = current[j] + 1;
            int64_t substitution = previous[j] + (seq_a[i] != seq_b[j] ? 1 : 0);
            current[j + 1] = std::min(std::min(deletion, insertion), substitution);
        }
        std::swap(previous, current);
    }
    return previous[n];
}

// Aggregate edit statistics: out_counts = {insertions, deletions, substitutions, correct}.
// Returns the final path cost.
float allophant_lev_statistics(const int32_t* seq_a, int32_t m, const int32_t* seq_b, int32_t n,
                               const float* sub_costs, float insertion_cost, float deletion_cost,
                               uint64_t* out_counts) {
    std::vector<float> matrix = full_matrix(seq_a, m, seq_b, n, sub_costs, insertion_cost, deletion_cost);
    uint64_t counts[4] = {0, 0, 0, 0};  // I, D, S, C
    backtrace(matrix, m, n, [&](Action action, int32_t, int32_t) {
        switch (action) {
            case kInsertion: ++counts[0]; break;
            case kDeletion: ++counts[1]; break;
            case kSubstitution: ++counts[2]; break;
            case kMatch: ++counts[3]; break;
        }
    });
    std::copy(counts, counts + 4, out_counts);
    return matrix[static_cast<size_t>(m) * (n + 1) + n];
}

// Best-path operations in order. Writes up to `capacity` (action, i, j)
// triples (matches omitted, as in the reference); returns the count and the
// final cost through `out_cost`.
int32_t allophant_lev_operations(const int32_t* seq_a, int32_t m, const int32_t* seq_b, int32_t n,
                                 const float* sub_costs, float insertion_cost, float deletion_cost,
                                 int8_t* out_actions, int32_t* out_i, int32_t* out_j,
                                 int32_t capacity, float* out_cost) {
    std::vector<float> matrix = full_matrix(seq_a, m, seq_b, n, sub_costs, insertion_cost, deletion_cost);
    *out_cost = matrix[static_cast<size_t>(m) * (n + 1) + n];
    int32_t count = 0;
    backtrace(matrix, m, n, [&](Action action, int32_t i, int32_t j) {
        if (action == kMatch) return;
        if (count < capacity) {
            out_actions[count] = action;
            out_i[count] = i;
            out_j[count] = j;
        }
        ++count;
    });
    // The backtrace emits in reverse order; flip in place.
    int32_t emitted = std::min(count, capacity);
    for (int32_t lo = 0, hi = emitted - 1; lo < hi; ++lo, --hi) {
        std::swap(out_actions[lo], out_actions[hi]);
        std::swap(out_i[lo], out_i[hi]);
        std::swap(out_j[lo], out_j[hi]);
    }
    return count;
}

// Full cost matrix ((m+1) x (n+1) row-major) for analysis parity.
void allophant_lev_matrix(const int32_t* seq_a, int32_t m, const int32_t* seq_b, int32_t n,
                          const float* sub_costs, float insertion_cost, float deletion_cost,
                          float* out_matrix) {
    std::vector<float> matrix = full_matrix(seq_a, m, seq_b, n, sub_costs, insertion_cost, deletion_cost);
    std::copy(matrix.begin(), matrix.end(), out_matrix);
}

}  // extern "C"
