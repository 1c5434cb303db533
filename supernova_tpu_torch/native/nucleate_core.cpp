// NucleateGraph glue phase, native core (hot loops of asm/nucleate.py).
//
// Implements exactly the reference-derived gluing semantics documented in
// asm/nucleate.py (GetMatches end-reaching overlaps, long-edge matches,
// involution-forced unions, Zipper label propagation) over flat closure
// arrays, returning the fully path-compressed boundary union-find parent
// (min element of each class — order-independent, so results are
// bit-identical to the Python implementation).
#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

inline int64_t uf_find(int64_t* p, int64_t x) {
    while (p[x] != x) {
        p[x] = p[p[x]];
        x = p[x];
    }
    return x;
}

inline void uf_union(int64_t* p, int64_t a, int64_t b) {
    a = uf_find(p, a);
    b = uf_find(p, b);
    if (a == b) return;
    if (a < b)
        p[b] = a;
    else
        p[a] = b;
}

}  // namespace

extern "C" int nucleate_glue(
    const int32_t* vals, const int64_t* offs, int64_t n,      // closures
    const int64_t* kmers, int64_t n_edges,                    // per-edge kmers
    const int64_t* cinv,                                      // closure involution
    int64_t min_over,        // kmer gate; adaptive when adaptive != 0
    int64_t min_over_floor,  // adaptive lower clamp (kmers)
    int32_t adaptive, int32_t interior, int32_t max_long_partners,
    const int64_t* extra_pairs, int64_t n_extra,  // pre-unions (merge mode)
    int64_t* parent          // (boundary_total,) prefilled identity, output
) {
    for (int64_t i = 0; i < n_extra; i++)
        uf_union(parent, extra_pairs[2 * i], extra_pairs[2 * i + 1]);
    std::vector<int64_t> cstart(n + 1, 0);
    for (int64_t i = 0; i < n; i++)
        cstart[i + 1] = cstart[i] + (offs[i + 1] - offs[i]) + 1;
    auto clen = [&](int64_t c) { return offs[c + 1] - offs[c]; };
    auto cedge = [&](int64_t c, int64_t j) { return vals[offs[c] + j]; };

    // ci: edge -> closure ids (deduped per closure)
    std::unordered_map<int32_t, std::vector<int64_t>> ci;
    for (int64_t i = 0; i < n; i++) {
        std::unordered_set<int32_t> seen;
        for (int64_t j = 0; j < clen(i); j++) {
            int32_t e = cedge(i, j);
            if (seen.insert(e).second) ci[e].push_back(i);
        }
    }

    auto union_match = [&](int64_t c1, int64_t s1, int64_t c2, int64_t s2,
                           int64_t L) {
        int64_t b1 = cstart[c1] + s1, b2 = cstart[c2] + s2;
        for (int64_t i = 0; i <= L; i++) uf_union(parent, b1 + i, b2 + i);
        int64_t r1 = cinv[c1], r2 = cinv[c2];
        int64_t rb1 = cstart[r1] + (clen(c1) - (s1 + L));
        int64_t rb2 = cstart[r2] + (clen(c2) - (s2 + L));
        for (int64_t i = 0; i <= L; i++) uf_union(parent, rb1 + i, rb2 + i);
    };

    auto extend = [&](int64_t c1, int64_t c2, int64_t j1, int64_t j2,
                      int64_t& s1, int64_t& s2, int64_t& L) {
        int64_t a = 0;
        while (j1 - a - 1 >= 0 && j2 - a - 1 >= 0 &&
               cedge(c1, j1 - a - 1) == cedge(c2, j2 - a - 1))
            a++;
        int64_t b = 1;
        while (j1 + b < clen(c1) && j2 + b < clen(c2) &&
               cedge(c1, j1 + b) == cedge(c2, j2 + b))
            b++;
        s1 = j1 - a;
        s2 = j2 - a;
        L = a + b;
    };

    // phase (a): overlap match candidates
    struct Cand {
        int64_t c1, s1, c2, s2, L, over;
    };
    std::vector<Cand> cands;
    for (int64_t i1 = 0; i1 < n; i1++) {
        std::vector<std::pair<int64_t, int32_t>> seeds;  // (pos, edge)
        if (interior) {
            std::unordered_set<int32_t> first;
            for (int64_t j = 0; j < clen(i1); j++) {
                int32_t e = cedge(i1, j);
                if (first.insert(e).second) seeds.push_back({j, e});
            }
        } else {
            int64_t nk = 0, b = -1, best = INT64_MAX;
            for (int64_t j = clen(i1) - 1; j >= 0; j--) {
                int64_t m = (int64_t)ci[cedge(i1, j)].size();
                if (m < best) {
                    best = m;
                    b = j;
                }
                nk += kmers[cedge(i1, j)];
                if (nk >= min_over) break;
            }
            seeds.push_back({b, cedge(i1, b)});
        }
        std::unordered_set<int64_t> done;  // (i2, offset) packed
        for (auto& sd : seeds) {
            int64_t b = sd.first;
            int32_t seed = sd.second;
            for (int64_t i2 : ci[seed]) {
                if (i2 == i1) continue;
                for (int64_t j2 = 0; j2 < clen(i2); j2++) {
                    if (cedge(i2, j2) != seed) continue;
                    int64_t key = i2 * 4000000LL + (b - j2 + 2000000LL);
                    if (done.count(key)) continue;
                    int64_t s1, s2, L;
                    extend(i1, i2, b, j2, s1, s2, L);
                    if (!interior) {
                        if (s1 + L < clen(i1)) continue;   // must reach end
                        if (s1 > 0 && s2 > 0) continue;    // must reach a start
                    }
                    int64_t over = 0;
                    for (int64_t z = s1; z < s1 + L; z++)
                        over += kmers[cedge(i1, z)];
                    done.insert(key);
                    cands.push_back({i1, s1, i2, s2, L, over});
                }
            }
        }
    }

    int64_t gate = min_over;
    if (adaptive && !cands.empty()) {
        std::vector<int64_t> overs;
        overs.reserve(cands.size());
        for (auto& c : cands) overs.push_back(c.over);
        size_t k = (size_t)(0.30 * (overs.size() - 1));
        std::nth_element(overs.begin(), overs.begin() + k, overs.end());
        int64_t p30 = overs[k];
        gate = std::max(min_over_floor, std::min(min_over, p30));
    }
    for (auto& c : cands)
        if (c.over >= gate) union_match(c.c1, c.s1, c.c2, c.s2, c.L);

    // phase (b): long-edge matches
    for (auto& kv : ci) {
        int32_t e = kv.first;
        if (kmers[e] < gate) continue;
        std::vector<std::pair<int64_t, int64_t>> Q;  // (closure, pos)
        for (int64_t c : kv.second)
            for (int64_t m = 0; m < clen(c); m++)
                if (cedge(c, m) == e) Q.push_back({c, m});
        if (Q.size() <= 1) continue;
        for (size_t a = 0; a < Q.size(); a++)
            for (size_t b = a + 1; b < Q.size(); b++) {
                if ((int64_t)(b - a) <= max_long_partners) {
                    int64_t s1, s2, L;
                    extend(Q[a].first, Q[b].first, Q[a].second, Q[b].second,
                           s1, s2, L);
                    union_match(Q[a].first, s1, Q[b].first, s2, L);
                } else {
                    union_match(Q[a].first, Q[a].second, Q[b].first,
                                Q[b].second, 1);
                }
            }
    }

    // Zipper: glued boundaries with identical continuation labels glue the
    // next boundaries too, forward and backward, to a fixpoint
    int64_t n_inst = offs[n];
    std::vector<int64_t> bl(n_inst), br(n_inst);
    std::vector<int32_t> lab(n_inst);
    {
        int64_t k = 0;
        for (int64_t c = 0; c < n; c++)
            for (int64_t j = 0; j < clen(c); j++, k++) {
                bl[k] = cstart[c] + j;
                br[k] = bl[k] + 1;
                lab[k] = cedge(c, j);
            }
    }
    std::vector<int64_t> order(n_inst);
    for (int pass = 0; pass < 200; pass++) {
        bool changed = false;
        for (int dir = 0; dir < 2; dir++) {
            const std::vector<int64_t>& heads = dir == 0 ? bl : br;
            const std::vector<int64_t>& tails = dir == 0 ? br : bl;
            for (int64_t i = 0; i < n_inst; i++) order[i] = i;
            std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
                int64_t hx = uf_find(parent, heads[x]);
                int64_t hy = uf_find(parent, heads[y]);
                if (hx != hy) return hx < hy;
                return lab[x] < lab[y];
            });
            for (int64_t i = 1; i < n_inst; i++) {
                int64_t x = order[i - 1], y = order[i];
                if (lab[x] != lab[y]) continue;
                if (uf_find(parent, heads[x]) != uf_find(parent, heads[y]))
                    continue;
                int64_t tx = uf_find(parent, tails[x]);
                int64_t ty = uf_find(parent, tails[y]);
                if (tx != ty) {
                    uf_union(parent, tx, ty);
                    changed = true;
                }
            }
        }
        if (!changed) break;
    }

    // full compression
    int64_t total = cstart[n];
    for (int64_t i = 0; i < total; i++) parent[i] = uf_find(parent, i);
    return 0;
}
