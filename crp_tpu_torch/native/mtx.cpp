// Matrix Market coordinate reader for the port's host layer, loaded with
// ctypes by crp_tpu_torch/native/__init__.py.  A copy, statement for
// statement, of crp_mtx_stat and crp_mtx_read in crp_tpu/native/
// fastops.cpp, so that both packages read a file into the same COO
// triplets: the stat refuses what the reader does not parse (no
// "coordinate" banner, complex, hermitian or skew fields), and the caller
// then takes scipy's reader.
//
// Build: g++ -O3 -shared -fPIC mtx.cpp -o libcrp_mtx.so

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Matrix Market coordinate parser.  Two-phase: stat then read.
// field: 0 real/double, 1 integer, 2 pattern.  symm: 0 general, 1 symmetric.
int crp_mtx_stat(const char* path, int64_t* nrow, int64_t* ncol,
                 int64_t* nnz_stored, int* symm, int* field)
{
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    char line[1024];
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
    for (char* p = line; *p; p++) *p = (char)std::tolower(*p);
    if (!std::strstr(line, "%%matrixmarket") ||
        !std::strstr(line, "coordinate")) { std::fclose(f); return -3; }
    *field = std::strstr(line, "pattern") ? 2
           : std::strstr(line, "integer") ? 1 : 0;
    if (std::strstr(line, "complex") || std::strstr(line, "hermitian") ||
        std::strstr(line, "skew")) { std::fclose(f); return -4; }
    *symm = std::strstr(line, "symmetric") ? 1 : 0;
    while (std::fgets(line, sizeof line, f))
        if (line[0] != '%') break;
    long long m, n, z;
    if (std::sscanf(line, "%lld %lld %lld", &m, &n, &z) != 3) {
        std::fclose(f);
        return -5;
    }
    *nrow = m; *ncol = n; *nnz_stored = z;
    std::fclose(f);
    return 0;
}

// Read entries (0-based output).  rows/cols/vals must have capacity for
// nnz_stored * (symmetric expansion ? 2 : 1).  Returns final nnz or < 0.
int64_t crp_mtx_read(const char* path, int64_t nnz_stored, int expand_symm,
                     int field, int64_t* rows, int64_t* cols, double* vals)
{
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    char line[1024];
    // skip banner + comments + size line
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
    while (std::fgets(line, sizeof line, f))
        if (line[0] != '%') break;  // size line consumed
    int64_t idx = 0;
    for (int64_t i = 0; i < nnz_stored; i++) {
        if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -6; }
        char* p = line;
        int64_t r = std::strtoll(p, &p, 10) - 1;
        int64_t c = std::strtoll(p, &p, 10) - 1;
        double v = (field == 2) ? 1.0 : std::strtod(p, &p);
        rows[idx] = r; cols[idx] = c; vals[idx] = v;
        idx++;
        if (expand_symm && r != c) {
            rows[idx] = c; cols[idx] = r; vals[idx] = v;
            idx++;
        }
    }
    std::fclose(f);
    return idx;
}

}  // extern "C"
