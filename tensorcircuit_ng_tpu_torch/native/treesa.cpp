// Simulated-annealing contraction-tree optimizer.
//
// Plays the role of omeco (Rust TreeSA) / kahypar in the reference's
// contraction stack (reference cons.py:653-703, 1166-1219): given an einsum
// network (tensor -> index-id lists, index sizes), search for a pairwise
// contraction tree minimizing a cost blending peak intermediate size and
// total flops.  Host-side, offline; exposed through a C ABI consumed by
// ctypes (tensorcircuit_ng_tpu/core/native.py).
//
// Build: g++ -O2 -shared -fPIC -o libtreesa.so treesa.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <random>
#include <set>
#include <memory>
#include <algorithm>
#include <algorithm>

namespace {

using Bits = std::vector<uint64_t>;

struct Network {
    int num_tensors;
    int num_indices;
    std::vector<Bits> tensor_inds;   // bitset of index ids per tensor
    Bits output_inds;                // open indices
    std::vector<double> log2_size;   // per index id
    std::vector<int> index_count;    // how many tensors touch each index
};

inline void set_bit(Bits& b, int i) { b[i >> 6] |= (uint64_t(1) << (i & 63)); }
inline bool get_bit(const Bits& b, int i) { return (b[i >> 6] >> (i & 63)) & 1; }

inline Bits bits_or(const Bits& a, const Bits& b) {
    Bits r(a.size());
    for (size_t i = 0; i < a.size(); ++i) r[i] = a[i] | b[i];
    return r;
}

inline Bits bits_and(const Bits& a, const Bits& b) {
    Bits r(a.size());
    for (size_t i = 0; i < a.size(); ++i) r[i] = a[i] & b[i];
    return r;
}

inline Bits bits_andnot(const Bits& a, const Bits& b) {
    Bits r(a.size());
    for (size_t i = 0; i < a.size(); ++i) r[i] = a[i] & ~b[i];
    return r;
}

inline bool bits_any(const Bits& a) {
    for (uint64_t w : a) if (w) return true;
    return false;
}

double bits_log2_size(const Bits& b, const std::vector<double>& lsz) {
    double s = 0.0;
    for (size_t w = 0; w < b.size(); ++w) {
        uint64_t x = b[w];
        while (x) {
            int i = __builtin_ctzll(x);
            s += lsz[w * 64 + i];
            x &= x - 1;
        }
    }
    return s;
}

// Contraction tree as a binary tree over leaves [0, n).
struct Tree {
    // nodes 0..n-1 are leaves; internal nodes n..2n-2
    std::vector<int> left, right, parent;
    int root;
    int n;
};

struct CostAccum {
    double peak_log2 = 0.0;     // max log2 intermediate size
    double total_flops = 0.0;   // sum of 2^(log2 contraction size)
};

// Recursively evaluate: returns the index bitset "visible" above this node.
Bits eval_node(const Tree& t, const Network& net, int node,
               const std::vector<Bits>& leaf_inds,
               const std::vector<Bits>& rest_union,  // union of inds outside subtree
               CostAccum& acc);

// Precompute union of leaf indices for an arbitrary set is expensive; instead
// evaluate with the classic trick: an index survives a contraction iff it
// appears in the output or in a tensor outside the contracted pair's subtree.
// We do a two-pass: bottom-up unions, then top-down "outside" sets.

struct Eval {
    const Network& net;
    const Tree& t;
    std::vector<Bits> sub_union;   // union of leaf indices within subtree
    std::vector<Bits> outside;     // union of indices outside subtree + output
    CostAccum acc;

    Eval(const Network& n_, const Tree& t_) : net(n_), t(t_) {
        int total = 2 * t.n - 1;
        sub_union.assign(total, Bits(net.tensor_inds[0].size(), 0));
        outside.assign(total, Bits(net.tensor_inds[0].size(), 0));
    }

    void up(int node) {
        if (node < t.n) { sub_union[node] = net.tensor_inds[node]; return; }
        up(t.left[node]); up(t.right[node]);
        sub_union[node] = bits_or(sub_union[t.left[node]], sub_union[t.right[node]]);
    }

    void down(int node, const Bits& out_above) {
        outside[node] = out_above;
        if (node < t.n) return;
        int l = t.left[node], r = t.right[node];
        down(l, bits_or(out_above, sub_union[r]));
        down(r, bits_or(out_above, sub_union[l]));
    }

    void cost(int node) {
        if (node < t.n) return;
        cost(t.left[node]); cost(t.right[node]);
        // result indices of this contraction: (union of children) ∩ outside
        Bits res = bits_and(sub_union[node], outside[node]);
        double rsize = bits_log2_size(res, net.log2_size);
        if (rsize > acc.peak_log2) acc.peak_log2 = rsize;
        // contraction flops ~ size of union of all involved indices
        double csize = bits_log2_size(sub_union[node], net.log2_size);
        // cap exponent to avoid inf
        acc.total_flops += std::pow(2.0, std::min(csize, 300.0));
    }

    CostAccum run() {
        up(t.root);
        down(t.root, net.output_inds);
        cost(t.root);
        return acc;
    }
};

double score(const CostAccum& c, double size_weight) {
    double lf = std::log2(std::max(c.total_flops, 1.0));
    return size_weight * c.peak_log2 + (1.0 - size_weight) * lf;
}

// Build an initial greedy tree (min result size among index-sharing pairs).
Tree greedy_tree(const Network& net, std::mt19937& rng, bool randomize) {
    int n = net.num_tensors;
    Tree t;
    t.n = n;
    int total = 2 * n - 1;
    t.left.assign(total, -1);
    t.right.assign(total, -1);
    t.parent.assign(total, -1);

    struct Act { int node; Bits inds; };
    std::vector<Act> active;
    active.reserve(n);
    for (int i = 0; i < n; ++i) active.push_back({i, net.tensor_inds[i]});
    int next_node = n;

    // per-index multiplicity among active tensors (for survivor test)
    std::vector<int> cnt(net.num_indices, 0);
    for (const auto& a : active)
        for (int i = 0; i < net.num_indices; ++i)
            if (get_bit(a.inds, i)) cnt[i]++;

    auto survivors = [&](const Bits& A, const Bits& B) {
        Bits uni = bits_or(A, B);
        Bits res(uni.size(), 0);
        for (int i = 0; i < net.num_indices; ++i) {
            if (!get_bit(uni, i)) continue;
            int inside = (get_bit(A, i) ? 1 : 0) + (get_bit(B, i) ? 1 : 0);
            if (get_bit(net.output_inds, i) || cnt[i] > inside) set_bit(res, i);
        }
        return res;
    };

    std::uniform_real_distribution<double> unif(0.0, 1.0);
    while (active.size() > 1) {
        double best = 1e300;
        int bi = 0, bj = 1;
        Bits best_res;
        for (size_t a = 0; a < active.size(); ++a) {
            for (size_t b = a + 1; b < active.size(); ++b) {
                bool shares = bits_any(bits_and(active[a].inds, active[b].inds));
                if (!shares && active.size() > 2) continue;  // defer outer products
                Bits res = survivors(active[a].inds, active[b].inds);
                double sc = bits_log2_size(res, net.log2_size);
                if (randomize) sc += unif(rng);
                if (sc < best) { best = sc; bi = (int)a; bj = (int)b; best_res = res; }
            }
        }
        if (best >= 1e300) {  // only outer products left
            bi = 0; bj = 1;
            best_res = survivors(active[0].inds, active[1].inds);
        }
        // update multiplicities: contracted-away indices leave the pool
        for (int i = 0; i < net.num_indices; ++i) {
            int inside = (get_bit(active[bi].inds, i) ? 1 : 0) +
                         (get_bit(active[bj].inds, i) ? 1 : 0);
            if (inside) cnt[i] -= inside;
            if (get_bit(best_res, i)) cnt[i] += 1;
        }
        int nn = next_node++;
        t.left[nn] = active[bi].node;
        t.right[nn] = active[bj].node;
        t.parent[active[bi].node] = nn;
        t.parent[active[bj].node] = nn;
        Act merged{nn, best_res};
        active.erase(active.begin() + bj);  // bj > bi always
        active.erase(active.begin() + bi);
        active.push_back(merged);
    }
    t.root = active[0].node;
    return t;
}


// ---------------------------------------------------------------------------
// Incremental SA engine: O(num_indices) per move instead of a full-tree
// re-evaluation.  Key facts: (1) the set of indices surviving at node v
// depends only on v's per-index leaf counts (an index survives iff it is in
// the output or appears in a leaf OUTSIDE v, i.e. total_cnt > cnt_v), and
// (2) an associativity rotation at (p, c) changes only c's leaf multiset —
// so exactly res[c], cost[c] and cost[p] need recomputing.  This affords
// ~10^6 moves where the full re-eval managed ~10^3, and fixes the old cost
// model (which charged the union of ALL leaf indices under a node instead
// of the surviving indices actually contracted there).
// ---------------------------------------------------------------------------

struct Inc {
    const Network& net;
    Tree& t;
    int n, total, nidx;
    std::vector<uint16_t> cnt;        // per node: nidx counts (leaf multiset)
    std::vector<uint16_t> total_cnt;  // per index, over all leaves
    std::vector<Bits> res;            // surviving indices per node
    std::vector<double> res_size;     // log2 size of res
    std::vector<double> cost;         // per internal node: log2 contraction size
    std::multiset<double> costs;      // cost[] of internal nodes (log2 space)
    std::multiset<double> peaks;      // res_size of internal nodes
    // tempered-flops accumulator sum 2^(gamma*cost): with gamma ~ 0.3 every
    // node contributes to the acceptance signal (the true flops sum is
    // dominated by the top node, leaving SA a gradient-free plateau);
    // magnitudes stay ~2^30 so a plain double accumulator is safe
    double gamma = 0.3;
    double guide_sum = 0.0;

    // undo record
    int u_p = -1, u_c = -1, u_moved = -1, u_other = -1;
    std::vector<uint16_t> u_cnt_c;
    Bits u_res_c;
    double u_res_size_c = 0, u_cost_c = 0, u_cost_p = 0;

    Inc(const Network& net_, Tree& t_)
        : net(net_), t(t_), n(t_.n), total(2 * t_.n - 1),
          nidx(net_.num_indices) {
        cnt.assign((size_t)total * nidx, 0);
        total_cnt.assign(nidx, 0);
        res.assign(total, Bits(net.tensor_inds[0].size(), 0));
        res_size.assign(total, 0.0);
        cost.assign(total, 0.0);
        for (int v = 0; v < n; ++v)
            for (int i = 0; i < nidx; ++i)
                if (get_bit(net.tensor_inds[v], i)) {
                    cnt[(size_t)v * nidx + i] = 1;
                    total_cnt[i] += 1;
                }
        build(t.root);
    }

    void compute_res(int v) {
        Bits& r = res[v];
        std::fill(r.begin(), r.end(), 0);
        const uint16_t* cv = &cnt[(size_t)v * nidx];
        double sz = 0.0;
        for (int i = 0; i < nidx; ++i) {
            if (cv[i] == 0) continue;
            if (get_bit(net.output_inds, i) || total_cnt[i] > cv[i]) {
                set_bit(r, i);
                sz += net.log2_size[i];
            }
        }
        res_size[v] = sz;
    }

    double union_size(const Bits& a, const Bits& b) const {
        double s = 0.0;
        for (size_t w = 0; w < a.size(); ++w) {
            uint64_t x = a[w] | b[w];
            while (x) {
                int i = __builtin_ctzll(x);
                s += net.log2_size[w * 64 + i];
                x &= x - 1;
            }
        }
        return s;
    }

    void build(int v) {
        if (v < n) { compute_res(v); return; }
        int l = t.left[v], r = t.right[v];
        build(l); build(r);
        uint16_t* cv = &cnt[(size_t)v * nidx];
        const uint16_t* cl = &cnt[(size_t)l * nidx];
        const uint16_t* cr = &cnt[(size_t)r * nidx];
        for (int i = 0; i < nidx; ++i) cv[i] = cl[i] + cr[i];
        compute_res(v);
        cost[v] = union_size(res[l], res[r]);
        costs.insert(cost[v]);
        peaks.insert(res_size[v]);
        guide_sum += std::pow(2.0, gamma * std::min(cost[v], 120.0));
    }

    double score(double size_weight) const {
        // stable log2(sum of 2^cost) from the top of the cost multiset —
        // a float accumulator cancels catastrophically at 2^90 scales
        double lf = 0.0;
        if (!costs.empty()) {
            double m = *costs.rbegin();
            double acc = 0.0;
            for (auto it = costs.rbegin(); it != costs.rend(); ++it) {
                if (*it < m - 40.0) break;
                acc += std::pow(2.0, *it - m);
            }
            lf = m + std::log2(acc);
        }
        double pk = peaks.empty() ? 0.0 : *peaks.rbegin();
        return size_weight * pk + (1.0 - size_weight) * lf;
    }

    // perform the rotation and incrementally update; record undo info.
    // Move selection is a cost tournament 70% of the time: the score is
    // dominated by the most expensive contractions, so uniform rotations
    // are almost always zero-delta random walk (measured: 99% accepts,
    // zero improvements on hard circuit networks); attacking the top-cost
    // nodes gives the annealer an actual gradient.
    bool rotate(std::mt19937& rng) {
        std::uniform_int_distribution<int> pick(n, total - 1);
        int p = -1, c = -1, moved = -1, other = -1;
        bool tournament = (rng() % 10) < 7;
        for (int attempt = 0; attempt < 16; ++attempt) {
            int pp = -1;
            if (tournament) {
                double bc = -1.0;
                for (int k = 0; k < 16; ++k) {
                    int cand = pick(rng);
                    if (t.left[cand] < n && t.right[cand] < n) continue;
                    if (cost[cand] > bc) { bc = cost[cand]; pp = cand; }
                }
                if (pp < 0) continue;
            } else {
                pp = pick(rng);
            }
            int l = t.left[pp], r = t.right[pp];
            bool l_int = l >= n, r_int = r >= n;
            if (!l_int && !r_int) continue;
            int cc = (l_int && r_int) ? ((rng() & 1) ? l : r) : (l_int ? l : r);
            p = pp; c = cc;
            other = (c == t.left[p]) ? t.right[p] : t.left[p];
            moved = (rng() & 1) ? t.left[c] : t.right[c];
            break;
        }
        if (p < 0) return false;
        // save undo
        u_p = p; u_c = c; u_moved = moved; u_other = other;
        u_cnt_c.assign(&cnt[(size_t)c * nidx], &cnt[(size_t)c * nidx] + nidx);
        u_res_c = res[c];
        u_res_size_c = res_size[c];
        u_cost_c = cost[c];
        u_cost_p = cost[p];
        // tree swap
        if (t.left[c] == moved) t.left[c] = other; else t.right[c] = other;
        if (t.left[p] == other) t.left[p] = moved; else t.right[p] = moved;
        t.parent[other] = c;
        t.parent[moved] = p;
        // incremental update of c then p
        int cl = t.left[c], cr = t.right[c];
        uint16_t* cv = &cnt[(size_t)c * nidx];
        const uint16_t* a = &cnt[(size_t)cl * nidx];
        const uint16_t* b = &cnt[(size_t)cr * nidx];
        for (int i = 0; i < nidx; ++i) cv[i] = a[i] + b[i];
        costs.erase(costs.find(cost[c]));
        costs.erase(costs.find(cost[p]));
        peaks.erase(peaks.find(res_size[c]));
        guide_sum -= std::pow(2.0, gamma * std::min(cost[c], 120.0));
        guide_sum -= std::pow(2.0, gamma * std::min(cost[p], 120.0));
        compute_res(c);
        peaks.insert(res_size[c]);
        cost[c] = union_size(res[cl], res[cr]);
        cost[p] = union_size(res[t.left[p]], res[t.right[p]]);
        costs.insert(cost[c]);
        costs.insert(cost[p]);
        guide_sum += std::pow(2.0, gamma * std::min(cost[c], 120.0));
        guide_sum += std::pow(2.0, gamma * std::min(cost[p], 120.0));
        return true;
    }

    void undo() {
        int p = u_p, c = u_c, moved = u_moved, other = u_other;
        costs.erase(costs.find(cost[c]));
        costs.erase(costs.find(cost[p]));
        peaks.erase(peaks.find(res_size[c]));
        guide_sum -= std::pow(2.0, gamma * std::min(cost[c], 120.0));
        guide_sum -= std::pow(2.0, gamma * std::min(cost[p], 120.0));
        // reverse the tree swap
        if (t.left[c] == other) t.left[c] = moved; else t.right[c] = moved;
        if (t.left[p] == moved) t.left[p] = other; else t.right[p] = other;
        t.parent[other] = p;
        t.parent[moved] = c;
        std::copy(u_cnt_c.begin(), u_cnt_c.end(), &cnt[(size_t)c * nidx]);
        res[c] = u_res_c;
        res_size[c] = u_res_size_c;
        cost[c] = u_cost_c;
        cost[p] = u_cost_p;
        peaks.insert(res_size[c]);
        costs.insert(cost[c]);
        costs.insert(cost[p]);
        guide_sum += std::pow(2.0, gamma * std::min(cost[c], 120.0));
        guide_sum += std::pow(2.0, gamma * std::min(cost[p], 120.0));
    }

    double guide_score(double size_weight) const {
        double pk = peaks.empty() ? 0.0 : *peaks.rbegin();
        double lf = std::log2(std::max(guide_sum, 1e-300)) / gamma;
        return size_weight * pk + (1.0 - size_weight) * lf;
    }
};

// SA move: swap a random subtree `other` (child of p) with a random subtree
// `moved` (grandchild of p through internal child c) — the classic
// associativity rotation on contraction trees.
bool random_rotate(Tree& t, std::mt19937& rng) {
    int n = t.n;
    int total = 2 * n - 1;
    std::uniform_int_distribution<int> pick(n, total - 1);
    for (int attempt = 0; attempt < 16; ++attempt) {
        int p = pick(rng);
        int l = t.left[p], r = t.right[p];
        bool l_int = l >= n, r_int = r >= n;
        if (!l_int && !r_int) continue;
        int c = (l_int && r_int) ? ((rng() & 1) ? l : r) : (l_int ? l : r);
        int other = (c == l) ? r : l;
        int moved = (rng() & 1) ? t.left[c] : t.right[c];
        if (t.left[c] == moved) t.left[c] = other; else t.right[c] = other;
        if (t.left[p] == other) t.left[p] = moved; else t.right[p] = moved;
        t.parent[other] = c;
        t.parent[moved] = p;
        return true;
    }
    return false;
}

// Emit SSA-format pairs: contraction k consumes two prior SSA ids and
// produces SSA id n+k (post-order renumbering survives tree rotations).
int emit_ssa_path(const Tree& t, int node, std::vector<int>& order, int& next_ssa) {
    if (node < t.n) return node;
    int a = emit_ssa_path(t, t.left[node], order, next_ssa);
    int b = emit_ssa_path(t, t.right[node], order, next_ssa);
    order.push_back(a);
    order.push_back(b);
    return next_ssa++;
}

}  // namespace

extern "C" {

double treesa_optimize_seeded(
    int num_tensors, int num_indices, const int* flat_inds, const int* offsets,
    const int* output_inds, int num_output, const double* log2_sizes,
    int n_iters, double t0, double t1, double size_weight, uint64_t seed,
    const int* init_ssa, int* out_path);

// inputs: flat index-id lists with per-tensor offsets; sizes: per index log2
// out_path: buffer of 2*(num_tensors-1) ints receiving SSA id pairs
// returns: final score (lower is better); -1 on error
double treesa_optimize(
    int num_tensors,
    int num_indices,
    const int* flat_inds,
    const int* offsets,        // length num_tensors+1
    const int* output_inds,
    int num_output,
    const double* log2_sizes,  // length num_indices
    int n_iters,
    double t0,
    double t1,
    double size_weight,
    uint64_t seed,
    int* out_path) {
    return treesa_optimize_seeded(
        num_tensors, num_indices, flat_inds, offsets, output_inds, num_output,
        log2_sizes, n_iters, t0, t1, size_weight, seed, nullptr, out_path);
}

// like treesa_optimize but optionally seeded with an initial SSA tree
double treesa_optimize_seeded(
    int num_tensors,
    int num_indices,
    const int* flat_inds,
    const int* offsets,
    const int* output_inds,
    int num_output,
    const double* log2_sizes,
    int n_iters,
    double t0,
    double t1,
    double size_weight,
    uint64_t seed,
    const int* init_ssa,       // 2*(num_tensors-1) SSA pairs, or NULL
    int* out_path) {
    if (num_tensors < 2) return -1.0;
    Network net;
    net.num_tensors = num_tensors;
    net.num_indices = num_indices;
    int words = (num_indices + 63) / 64;
    net.tensor_inds.assign(num_tensors, Bits(words, 0));
    for (int i = 0; i < num_tensors; ++i)
        for (int k = offsets[i]; k < offsets[i + 1]; ++k)
            set_bit(net.tensor_inds[i], flat_inds[k]);
    net.output_inds.assign(words, 0);
    for (int k = 0; k < num_output; ++k) set_bit(net.output_inds, output_inds[k]);
    net.log2_size.assign(log2_sizes, log2_sizes + num_indices);

    std::mt19937 rng(seed ? seed : 42);
    Tree best;
    if (init_ssa != nullptr) {
        // caller-provided seed tree (SSA pairs): SA starts from a known-good
        // plan (e.g. opt_einsum greedy) and can only improve on it
        int total = 2 * num_tensors - 1;
        best.n = num_tensors;
        best.left.assign(total, -1);
        best.right.assign(total, -1);
        best.parent.assign(total, -1);
        for (int k = 0; k < num_tensors - 1; ++k) {
            int a = init_ssa[2 * k], b = init_ssa[2 * k + 1];
            int nn = num_tensors + k;
            best.left[nn] = a;
            best.right[nn] = b;
            best.parent[a] = nn;
            best.parent[b] = nn;
        }
        best.root = total - 1;
    } else {
        best = greedy_tree(net, rng, false);
    }
    double best_score = 0.0;  // set from the incremental engine below
    Tree cur = best;
    std::unique_ptr<Inc> inc(new Inc(net, cur));
    double cur_guide = inc->guide_score(size_weight);
    best_score = inc->score(size_weight);
    double best_guide = cur_guide;
    int restart_every = std::max(n_iters / 8, 1);

    std::uniform_real_distribution<double> unif(0.0, 1.0);
    for (int it = 0; it < n_iters; ++it) {
        double frac = double(it) / std::max(1, n_iters - 1);
        double temp = t0 * std::pow(t1 / t0, frac);
        if (it > 0 && it % restart_every == 0 && cur_guide > best_guide) {
            // plateau drift destroys good trees between improvements;
            // periodically resume the anneal from the best-seen tree
            cur = best;
            inc.reset(new Inc(net, cur));
            cur_guide = inc->guide_score(size_weight);
        }
        if (!inc->rotate(rng)) continue;
        double s = inc->guide_score(size_weight);
        if (s < cur_guide || unif(rng) < std::exp((cur_guide - s) / std::max(temp, 1e-9))) {
            cur_guide = s;
            if (s < best_guide) {
                best_guide = s;
                double true_s = inc->score(size_weight);
                if (true_s < best_score) { best = cur; best_score = true_s; }
            }
        } else {
            inc->undo();
        }
    }

    std::vector<int> order;
    int next_ssa = num_tensors;
    emit_ssa_path(best, best.root, order, next_ssa);
    std::memcpy(out_path, order.data(), order.size() * sizeof(int));
    return best_score;
}

}  // extern "C"
