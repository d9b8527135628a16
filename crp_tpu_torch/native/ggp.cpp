// Greedy graph-growing K-way row partition (GGGP) for the port's host
// layer, loaded with ctypes by crp_tpu_torch/native/__init__.py.  A copy,
// statement for statement, of crp_ggp_partition in crp_tpu/native/
// fastops.cpp: the partition's decisions depend on std::sort's order of
// equal degrees in by_deg and on the max-heap's order of equal gains, so
// neither is changed here.
//
// Build: g++ -O3 -shared -fPIC ggp.cpp -o libcrp_ggp.so

#include <algorithm>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Greedy graph-growing K-way row partition: the native engine behind the
// METIS seam when no libmetis/pymetis is installed (the reference links
// METIS_PartGraphKway, examples/metis_mat_part.c:44-62).  Parts are grown
// one at a time from a minimum-degree seed, repeatedly absorbing the
// frontier vertex with the most neighbors already inside the growing part
// (the GGGP gain METIS itself uses for its initial partitions), under a
// per-part size target of ceil(remaining / parts_left) capped at
// imbalance * nrow / nparts (the ubvec analog).  Disconnected components
// re-seed within the current part.  part_out[i] in [0, nparts).
int crp_ggp_partition(
    int64_t nrow, const int64_t* rowptr, const int32_t* colidx,
    int64_t nparts, double imbalance, int32_t* part_out)
{
    if (nrow <= 0) return 0;
    if (nparts <= 1) {
        for (int64_t i = 0; i < nrow; i++) part_out[i] = 0;
        return 0;
    }
    std::vector<int32_t> part(nrow, -1);
    std::vector<int64_t> by_deg(nrow);
    for (int64_t i = 0; i < nrow; i++) by_deg[i] = i;
    std::sort(by_deg.begin(), by_deg.end(), [&](int64_t a, int64_t b) {
        return (rowptr[a + 1] - rowptr[a]) < (rowptr[b + 1] - rowptr[b]);
    });
    int64_t seed_cursor = 0;
    // per-vertex "neighbors inside the current part", reset lazily by stamp
    std::vector<int64_t> in_cur(nrow, 0);
    std::vector<int32_t> stamp(nrow, -1);
    int64_t remaining = nrow;
    const int64_t cap =
        (int64_t)(imbalance * ((double)nrow / (double)nparts)) + 1;
    for (int32_t p = 0; p < (int32_t)nparts; p++) {
        int64_t parts_left = (int64_t)nparts - p;
        int64_t target = (remaining + parts_left - 1) / parts_left;
        if (target > cap) target = cap;
        if (p == (int32_t)nparts - 1) target = remaining;
        // lazy max-heap of (gain, vertex); stale entries skipped on pop
        std::priority_queue<std::pair<int64_t, int64_t>> heap;
        int64_t size = 0;
        while (size < target && remaining > 0) {
            int64_t v = -1;
            while (!heap.empty()) {
                std::pair<int64_t, int64_t> top = heap.top();
                heap.pop();
                int64_t u = top.second;
                if (part[u] != -1) continue;
                int64_t cur = (stamp[u] == p) ? in_cur[u] : 0;
                if (top.first != cur) { heap.push({cur, u}); continue; }
                v = u;
                break;
            }
            if (v == -1) {  // fresh part, or component exhausted: new seed
                while (seed_cursor < nrow && part[by_deg[seed_cursor]] != -1)
                    seed_cursor++;
                if (seed_cursor >= nrow) break;
                v = by_deg[seed_cursor];
            }
            part[v] = p;
            size++;
            remaining--;
            for (int64_t e = rowptr[v]; e < rowptr[v + 1]; e++) {
                int64_t w = colidx[e];
                if (w < 0 || w >= nrow || w == v || part[w] != -1) continue;
                if (stamp[w] != p) { stamp[w] = p; in_cur[w] = 0; }
                in_cur[w]++;
                heap.push({in_cur[w], w});
            }
        }
    }
    for (int64_t i = 0; i < nrow; i++)
        if (part[i] == -1) part[i] = (int32_t)(nparts - 1);
    std::copy(part.begin(), part.end(), part_out);
    return 0;
}

}  // extern "C"
