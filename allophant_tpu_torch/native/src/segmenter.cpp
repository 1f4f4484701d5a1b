// Aho-Corasick multi-pattern matcher with leftmost-longest, non-overlapping
// match iteration over UTF-8 byte strings.
//
// Native equivalent of the reference's Rust pyo3 IPA segmenter
// (the reference's src/ipa_segmenter.rs:96-140), which delegates to the
// aho-corasick crate with MatchKind::LeftmostLongest. This implementation is an
// independent design: a standard Aho-Corasick automaton (goto/fail/output links)
// enumerates *all* matches, and a linear post-pass selects the leftmost-longest
// non-overlapping subset. Inputs here are short IPA strings, so the all-matches
// set is tiny and this is both simple and fast.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <vector>

namespace {

struct Node {
    // Sparse goto transitions over bytes. IPA vocabularies are small (<6k
    // patterns, avg <4 bytes) so a sorted small vector beats a 256-wide table
    // on cache footprint while staying O(log k) per step.
    std::vector<std::pair<uint8_t, int32_t>> next;
    int32_t fail = 0;
    // Longest pattern ending at this node (-1 if none); chained via fail links.
    int32_t pattern = -1;
    int32_t pattern_len = 0;

    int32_t get(uint8_t byte) const {
        for (const auto& entry : next) {
            if (entry.first == byte) return entry.second;
        }
        return -1;
    }
};

struct Automaton {
    std::vector<Node> nodes;
    std::vector<std::string> patterns;

    explicit Automaton(const std::vector<std::string>& pats) : patterns(pats) {
        nodes.emplace_back();  // root
        for (size_t p = 0; p < patterns.size(); ++p) {
            const std::string& pat = patterns[p];
            if (pat.empty()) continue;
            int32_t state = 0;
            for (unsigned char byte : pat) {
                int32_t next_state = nodes[state].get(byte);
                if (next_state < 0) {
                    next_state = static_cast<int32_t>(nodes.size());
                    nodes[state].next.emplace_back(byte, next_state);
                    nodes.emplace_back();
                }
                state = next_state;
            }
            // Keep the longest (ties: first) pattern for identical strings.
            if (nodes[state].pattern < 0) {
                nodes[state].pattern = static_cast<int32_t>(p);
                nodes[state].pattern_len = static_cast<int32_t>(pat.size());
            }
        }
        // BFS fail links.
        std::queue<int32_t> queue;
        for (const auto& entry : nodes[0].next) {
            nodes[entry.second].fail = 0;
            queue.push(entry.second);
        }
        while (!queue.empty()) {
            int32_t state = queue.front();
            queue.pop();
            for (const auto& entry : nodes[state].next) {
                uint8_t byte = entry.first;
                int32_t child = entry.second;
                int32_t fail = nodes[state].fail;
                int32_t fail_next;
                while ((fail_next = nodes[fail].get(byte)) < 0 && fail != 0) {
                    fail = nodes[fail].fail;
                }
                if (fail_next < 0) fail_next = 0;
                nodes[child].fail = (fail_next == child) ? 0 : fail_next;
                queue.push(child);
            }
        }
    }

    int32_t step(int32_t state, uint8_t byte) const {
        int32_t next_state;
        while ((next_state = nodes[state].get(byte)) < 0 && state != 0) {
            state = nodes[state].fail;
        }
        return next_state < 0 ? 0 : next_state;
    }
};

}  // namespace

extern "C" {

// Builds an automaton from `count` UTF-8 patterns (lengths in `lengths`).
void* allophant_ac_build(const char** pattern_data, const int32_t* lengths, int32_t count) {
    std::vector<std::string> patterns;
    patterns.reserve(count);
    for (int32_t i = 0; i < count; ++i) {
        patterns.emplace_back(pattern_data[i], static_cast<size_t>(lengths[i]));
    }
    return new Automaton(patterns);
}

void allophant_ac_free(void* handle) { delete static_cast<Automaton*>(handle); }

// Leftmost-longest non-overlapping matches over `text` (byte offsets).
// Writes up to `capacity` (start, end) byte-offset pairs; returns the total
// number of matches (callers retry with a larger buffer if > capacity).
int32_t allophant_ac_find(const void* handle, const char* text, int32_t text_len,
                          int32_t* out_starts, int32_t* out_ends, int32_t capacity) {
    const Automaton& automaton = *static_cast<const Automaton*>(handle);
    // best_end[start] = longest match end for that start (exclusive), else 0.
    std::vector<int32_t> best_end(static_cast<size_t>(text_len) + 1, 0);
    int32_t state = 0;
    for (int32_t pos = 0; pos < text_len; ++pos) {
        state = automaton.step(state, static_cast<uint8_t>(text[pos]));
        // Walk the fail chain collecting every pattern ending at pos + 1.
        for (int32_t node = state; node != 0; node = automaton.nodes[node].fail) {
            if (automaton.nodes[node].pattern >= 0) {
                int32_t start = pos + 1 - automaton.nodes[node].pattern_len;
                if (pos + 1 > best_end[start]) best_end[start] = pos + 1;
            }
        }
    }
    // Leftmost-longest, non-overlapping selection.
    int32_t found = 0;
    int32_t cursor = 0;
    while (cursor <= text_len) {
        if (best_end[cursor] > cursor) {
            if (found < capacity) {
                out_starts[found] = cursor;
                out_ends[found] = best_end[cursor];
            }
            ++found;
            cursor = best_end[cursor];
        } else {
            ++cursor;
        }
    }
    return found;
}

}  // extern "C"
