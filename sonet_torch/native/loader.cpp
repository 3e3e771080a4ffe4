// Native host-side batch loader: npy/npz read + subsample + augmentation
// (the port's own copy of the JAX package's native/loader.cpp; the code
// below the includes is the same, so the same seeds give the same bytes).
//
// The counterpart of the reference's DataLoader worker processes
// (modelnet/train.py:25, num_workers=8): where the reference parallelizes
// python __getitem__ bodies (np.load + np.random.choice + numpy
// augmentation, modelnet_shrec_loader.py:193-245) across forked workers,
// this runs the whole per-item pipeline in C++ worker threads inside one
// shared library call, with the interpreter lock released and no numpy
// temporaries.  The Python wrapper (sonet_torch/data/native_loader.py)
// hands a batch of file paths and per-item seeds and receives collated
// (B, n, 3) arrays.
//
// Augmentation (data/augmentation.py:16-144 in the reference,
// sonet_torch/data/augmentation.py here): the same transforms and
// parameter ranges: uniform y-rotation applied to pc+sn+som, clipped
// 3-axis gaussian perturbation rotation, gaussian jitter (sigma .01 clip
// .05; som .04/.1), scale U(0.8,1.2), shift U(-0.1,0.1).  The random
// stream differs from numpy's (std::mt19937_64 vs PCG64): draws match in
// distribution, not bitwise; each item's draws are a function of
// (seed, mode, epoch, index), because Python derives one 64-bit seed per
// item from the same SeedSequence tuple the numpy path uses.
//
// npy format: v1.0/2.0 headers, little-endian '<f4', 2-D; both C and
// Fortran order (prep-som node files may be F-contiguous).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Npy {
  std::vector<float> data;
  int64_t rows = 0, cols = 0;
};

// minimal .npy reader: magic, version, header dict, raw f32 payload
bool read_npy_f32(const char* path, Npy* out, std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { *err = std::string("cannot open ") + path; return false; }
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    *err = std::string("bad npy magic: ") + path; std::fclose(f); return false;
  }
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (std::fread(b, 1, 2, f) != 2) { *err = "truncated header"; std::fclose(f); return false; }
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) { *err = "truncated header"; std::fclose(f); return false; }
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  }
  std::string hdr(hlen, '\0');
  if (std::fread(&hdr[0], 1, hlen, f) != hlen) {
    *err = "truncated header"; std::fclose(f); return false;
  }
  if (hdr.find("'<f4'") == std::string::npos &&
      hdr.find("\"<f4\"") == std::string::npos) {
    *err = std::string("npy dtype is not <f4: ") + path; std::fclose(f); return false;
  }
  bool fortran =
      hdr.find("'fortran_order': True") != std::string::npos;
  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) { *err = "no shape in header"; std::fclose(f); return false; }
  size_t lp = hdr.find('(', sp), rp = hdr.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) {
    *err = "bad shape"; std::fclose(f); return false;
  }
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  int64_t dims[4] = {0, 0, 0, 0};
  int nd = 0;
  const char* p = shape.c_str();
  while (*p && nd < 4) {
    while (*p == ' ' || *p == ',') p++;
    if (!*p) break;
    char* end = nullptr;
    long long v = std::strtoll(p, &end, 10);
    if (end == p) break;
    dims[nd++] = v;
    p = end;
  }
  if (nd == 1) { dims[1] = 1; nd = 2; }
  if (nd != 2) { *err = std::string("npy is not 2-D: ") + path; std::fclose(f); return false; }
  out->rows = dims[0];
  out->cols = dims[1];
  out->data.resize(size_t(dims[0]) * dims[1]);
  size_t want = out->data.size();
  if (std::fread(out->data.data(), 4, want, f) != want) {
    *err = std::string("truncated payload: ") + path; std::fclose(f); return false;
  }
  std::fclose(f);
  if (fortran && out->rows > 1 && out->cols > 1) {
    std::vector<float> t(out->data.size());
    for (int64_t r = 0; r < out->rows; r++)
      for (int64_t c = 0; c < out->cols; c++)
        t[size_t(r) * out->cols + c] = out->data[size_t(c) * out->rows + r];
    out->data.swap(t);
  }
  return true;
}

// ---------------------------------------------------------------------------
// npz (zip of npy members) support — np.savez writes STORED (method 0)
// entries, which need no inflate; central-directory walk finds members.
// ---------------------------------------------------------------------------

bool read_file(const char* path, std::vector<unsigned char>* buf,
               std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { *err = std::string("cannot open ") + path; return false; }
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(size_t(sz));
  if (std::fread(buf->data(), 1, size_t(sz), f) != size_t(sz)) {
    *err = std::string("short read: ") + path; std::fclose(f); return false;
  }
  std::fclose(f);
  return true;
}

inline uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
inline uint16_t rd16(const unsigned char* p) { return p[0] | (p[1] << 8); }

struct ZipMember {
  const unsigned char* data;
  size_t size;
};

// name -> payload view for every stored member of an in-memory zip
bool zip_members(const std::vector<unsigned char>& buf,
                 std::vector<std::pair<std::string, ZipMember>>* out,
                 std::string* err) {
  if (buf.size() < 22) { *err = "zip too small"; return false; }
  // EOCD signature scan from the tail (comment can follow)
  size_t eocd = size_t(-1);
  size_t lo = buf.size() >= (1 << 16) + 22 ? buf.size() - (1 << 16) - 22 : 0;
  for (size_t i = buf.size() - 22; ; i--) {
    if (rd32(&buf[i]) == 0x06054b50) { eocd = i; break; }
    if (i == lo) break;
  }
  if (eocd == size_t(-1)) { *err = "no zip end-of-central-directory"; return false; }
  uint16_t count = rd16(&buf[eocd + 10]);
  uint32_t cd_off = rd32(&buf[eocd + 16]);
  size_t p = cd_off;
  for (uint16_t e = 0; e < count; e++) {
    if (p + 46 > buf.size() || rd32(&buf[p]) != 0x02014b50) {
      *err = "bad zip central header"; return false;
    }
    uint16_t method = rd16(&buf[p + 10]);
    uint32_t csize = rd32(&buf[p + 20]);
    uint16_t nlen = rd16(&buf[p + 28]);
    uint16_t xlen = rd16(&buf[p + 30]);
    uint16_t clen = rd16(&buf[p + 32]);
    uint32_t lho = rd32(&buf[p + 42]);
    std::string name(reinterpret_cast<const char*>(&buf[p + 46]), nlen);
    if (method != 0) {
      *err = "npz member is compressed (deflated); only np.savez "
             "(stored) is supported: " + name;
      return false;
    }
    // local header: recompute payload offset (its name/extra lengths
    // can differ from the central copy)
    if (lho + 30 > buf.size() || rd32(&buf[lho]) != 0x04034b50) {
      *err = "bad zip local header"; return false;
    }
    uint16_t lnlen = rd16(&buf[lho + 26]);
    uint16_t lxlen = rd16(&buf[lho + 28]);
    size_t payload = lho + 30 + lnlen + lxlen;
    if (payload + csize > buf.size()) { *err = "zip payload OOB"; return false; }
    out->emplace_back(name, ZipMember{buf.data() + payload, csize});
    p += 46 + nlen + xlen + clen;
  }
  return true;
}

// npy-from-memory parser: '<f4'/'<f8' -> float, '<i4'/'<i8' -> int32
struct NpyView {
  int64_t rows = 0, cols = 0;
  std::vector<float> f;     // filled for float dtypes
  std::vector<int32_t> i;   // filled for int dtypes
  bool is_float = false;
};

bool parse_npy_mem(const unsigned char* p, size_t n, NpyView* out,
                   std::string* err) {
  if (n < 10 || std::memcmp(p, "\x93NUMPY", 6)) { *err = "bad npy magic"; return false; }
  int major = p[6];
  size_t hstart;
  uint32_t hlen;
  if (major == 1) { hlen = rd16(p + 8); hstart = 10; }
  else { hlen = rd32(p + 8); hstart = 12; }
  if (hstart + hlen > n) { *err = "truncated npy header"; return false; }
  std::string hdr(reinterpret_cast<const char*>(p + hstart), hlen);
  bool fortran =
      hdr.find("'fortran_order': True") != std::string::npos;
  int esize = 0;
  bool is_float = false;
  if (hdr.find("'<f4'") != std::string::npos) { esize = 4; is_float = true; }
  else if (hdr.find("'<f8'") != std::string::npos) { esize = 8; is_float = true; }
  else if (hdr.find("'<i4'") != std::string::npos) { esize = 4; }
  else if (hdr.find("'<i8'") != std::string::npos) { esize = 8; }
  else { *err = "unsupported npy dtype (want <f4/<f8/<i4/<i8)"; return false; }
  size_t sp = hdr.find("'shape':");
  size_t lp = hdr.find('(', sp), rp = hdr.find(')', sp);
  if (sp == std::string::npos || lp == std::string::npos ||
      rp == std::string::npos) { *err = "bad npy shape"; return false; }
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  int64_t dims[4] = {0, 0, 0, 0};
  int nd = 0;
  const char* s = shape.c_str();
  while (*s && nd < 4) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    char* end = nullptr;
    long long v = std::strtoll(s, &end, 10);
    if (end == s) break;
    dims[nd++] = v;
    s = end;
  }
  if (nd == 1) { dims[1] = 1; nd = 2; }
  if (nd != 2) { *err = "npy member is not 1-D/2-D"; return false; }
  out->rows = dims[0];
  out->cols = dims[1];
  out->is_float = is_float;
  size_t cnt = size_t(dims[0]) * size_t(dims[1]);
  const unsigned char* d = p + hstart + hlen;
  if (hstart + hlen + cnt * esize > n) { *err = "truncated npy payload"; return false; }
  if (is_float) {
    out->f.resize(cnt);
    if (esize == 4) std::memcpy(out->f.data(), d, cnt * 4);
    else
      for (size_t j = 0; j < cnt; j++) {
        double v;
        std::memcpy(&v, d + j * 8, 8);
        out->f[j] = float(v);
      }
  } else {
    out->i.resize(cnt);
    if (esize == 4) std::memcpy(out->i.data(), d, cnt * 4);
    else
      for (size_t j = 0; j < cnt; j++) {
        int64_t v;
        std::memcpy(&v, d + j * 8, 8);
        out->i[j] = int32_t(v);
      }
  }
  if (fortran && out->rows > 1 && out->cols > 1) {
    // column-major payload -> row-major view
    if (is_float) {
      std::vector<float> t(cnt);
      for (int64_t r = 0; r < out->rows; r++)
        for (int64_t c = 0; c < out->cols; c++)
          t[size_t(r) * out->cols + c] = out->f[size_t(c) * out->rows + r];
      out->f.swap(t);
    } else {
      std::vector<int32_t> t(cnt);
      for (int64_t r = 0; r < out->rows; r++)
        for (int64_t c = 0; c < out->cols; c++)
          t[size_t(r) * out->cols + c] = out->i[size_t(c) * out->rows + r];
      out->i.swap(t);
    }
  }
  return true;
}

bool npz_member(const std::vector<std::pair<std::string, ZipMember>>& ms,
                const std::string& name, NpyView* out, std::string* err) {
  for (auto& kv : ms)
    if (kv.first == name || kv.first == name + ".npy")
      return parse_npy_mem(kv.second.data, kv.second.size, out, err);
  *err = "npz member not found: " + name;
  return false;
}

struct Mat3 {
  double m[9];
  void apply(float* v) const {  // row-vector convention: v' = v @ M
    double x = v[0], y = v[1], z = v[2];
    v[0] = float(x * m[0] + y * m[3] + z * m[6]);
    v[1] = float(x * m[1] + y * m[4] + z * m[7]);
    v[2] = float(x * m[2] + y * m[5] + z * m[8]);
  }
};

Mat3 rot_y(double a) {
  double c = std::cos(a), s = std::sin(a);
  return Mat3{{c, 0, s, 0, 1, 0, -s, 0, c}};
}

Mat3 matmul(const Mat3& A, const Mat3& B) {  // A @ B
  Mat3 r{};
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int k = 0; k < 3; k++) s += A.m[i * 3 + k] * B.m[k * 3 + j];
      r.m[i * 3 + j] = s;
    }
  return r;
}

// small 3-axis rotation Rz @ Ry @ Rx with clipped gaussian angles
// (augmentation.py _perturbation_matrix)
Mat3 perturbation_matrix(std::mt19937_64& rng, double sigma, double clip) {
  std::normal_distribution<double> gauss(0.0, 1.0);
  double a[3];
  for (double& ai : a) {
    ai = sigma * gauss(rng);
    if (ai > clip) ai = clip;
    if (ai < -clip) ai = -clip;
  }
  double cx = std::cos(a[0]), sx = std::sin(a[0]);
  double cy = std::cos(a[1]), sy = std::sin(a[1]);
  double cz = std::cos(a[2]), sz = std::sin(a[2]);
  Mat3 Rx{{1, 0, 0, 0, cx, -sx, 0, sx, cx}};
  Mat3 Ry{{cy, 0, sy, 0, 1, 0, -sy, 0, cy}};
  Mat3 Rz{{cz, -sz, 0, sz, cz, 0, 0, 0, 1}};
  return matmul(matmul(Rz, Ry), Rx);
}

void jitter(float* v, int64_t n, std::mt19937_64& rng, double sigma,
            double clip) {
  std::normal_distribution<double> gauss(0.0, 1.0);
  for (int64_t i = 0; i < n; i++) {
    double d = sigma * gauss(rng);
    if (d > clip) d = clip;
    if (d < -clip) d = -clip;
    v[i] += float(d);
  }
}

// augmentation stacks, in the reference's draw order.
// mode 1 = modelnet/shrec full stack (modelnet_shrec_loader.py:219-245):
//   [rot_horizontal] [rot_perturbation] jitter(pc,sn) jitter(som .04/.1)
//   scale U(0.8,1.2) [shift U(-.1,.1) on pc+som]
// mode 2 = shapenet jitter+scale only (shapenet_loader.py:156-175)
void apply_augment(float* pc, float* sn, float* node, int64_t n_points,
                   int64_t n_nodes, std::mt19937_64& rng, int mode,
                   int rot_h, int rot_p, int trans_p) {
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  if (mode == 1 && rot_h) {
    Mat3 R = rot_y(uni(rng) * 2.0 * M_PI);
    for (int64_t j = 0; j < n_points; j++) R.apply(pc + j * 3);
    for (int64_t j = 0; j < n_points; j++) R.apply(sn + j * 3);
    for (int64_t j = 0; j < n_nodes; j++) R.apply(node + j * 3);
  }
  if (mode == 1 && rot_p) {
    Mat3 R = perturbation_matrix(rng, 0.06, 0.18);
    for (int64_t j = 0; j < n_points; j++) R.apply(pc + j * 3);
    for (int64_t j = 0; j < n_points; j++) R.apply(sn + j * 3);
    for (int64_t j = 0; j < n_nodes; j++) R.apply(node + j * 3);
  }
  jitter(pc, n_points * 3, rng, 0.01, 0.05);
  jitter(sn, n_points * 3, rng, 0.01, 0.05);
  jitter(node, n_nodes * 3, rng, 0.04, 0.10);
  double scale = 0.8 + 0.4 * uni(rng);
  for (int64_t j = 0; j < n_points * 3; j++) pc[j] *= float(scale);
  for (int64_t j = 0; j < n_points * 3; j++) sn[j] *= float(scale);
  for (int64_t j = 0; j < n_nodes * 3; j++) node[j] *= float(scale);
  if (mode == 1 && trans_p) {
    float shift[3];
    for (float& s : shift) s = float(-0.1 + 0.2 * uni(rng));
    for (int64_t j = 0; j < n_points; j++)
      for (int c = 0; c < 3; c++) pc[j * 3 + c] += shift[c];
    for (int64_t j = 0; j < n_nodes; j++)
      for (int c = 0; c < 3; c++) node[j * 3 + c] += shift[c];
  }
}

struct Args {
  const char** pc_paths;
  const char** som_paths;
  int64_t n_items, n_points, n_nodes;
  const uint64_t* item_seeds;
  int augment, rot_horizontal, rot_perturbation, translation_perturbation;
  float *pc_out, *sn_out, *node_out;
};

bool load_one(const Args& a, int64_t i, std::string* err) {
  Npy raw, som;
  if (!read_npy_f32(a.pc_paths[i], &raw, err)) return false;
  if (!read_npy_f32(a.som_paths[i], &som, err)) return false;
  if (raw.cols < 3) { *err = "pc npy has <3 columns"; return false; }
  bool has_sn = raw.cols >= 6;
  if (som.rows != a.n_nodes || som.cols != 3) {
    *err = "som npy shape mismatch";
    return false;
  }
  if (raw.rows < a.n_points) { *err = "fewer points than n_points"; return false; }

  std::mt19937_64 rng(a.item_seeds[i]);

  // distinct random subsample (np.random.choice replace=False semantics,
  // modelnet_shrec_loader.py:198): partial Fisher-Yates over row indices
  int64_t N = raw.rows;
  std::vector<int32_t> idx(N);
  for (int64_t j = 0; j < N; j++) idx[j] = int32_t(j);
  for (int64_t j = 0; j < a.n_points; j++) {
    std::uniform_int_distribution<int64_t> pick(j, N - 1);
    std::swap(idx[j], idx[pick(rng)]);
  }

  float* pc = a.pc_out + i * a.n_points * 3;
  float* sn = a.sn_out + i * a.n_points * 3;
  float* node = a.node_out + i * a.n_nodes * 3;
  for (int64_t j = 0; j < a.n_points; j++) {
    const float* row = raw.data.data() + size_t(idx[j]) * raw.cols;
    pc[j * 3 + 0] = row[0];
    pc[j * 3 + 1] = row[1];
    pc[j * 3 + 2] = row[2];
    if (has_sn) {
      sn[j * 3 + 0] = row[3];
      sn[j * 3 + 1] = row[4];
      sn[j * 3 + 2] = row[5];
    } else {
      sn[j * 3 + 0] = sn[j * 3 + 1] = sn[j * 3 + 2] = 0.0f;
    }
  }
  std::memcpy(node, som.data.data(), size_t(a.n_nodes) * 3 * sizeof(float));

  if (a.augment)
    apply_augment(pc, sn, node, a.n_points, a.n_nodes, rng, 1,
                  a.rot_horizontal, a.rot_perturbation,
                  a.translation_perturbation);
  return true;
}

struct NpzArgs {
  const char** paths;
  int64_t n_items, n_points, n_nodes;
  const uint64_t* item_seeds;
  int augment_mode;  // 0 none; 1 full stack; 2 jitter+scale (shapenet)
  int rot_horizontal, rot_perturbation, translation_perturbation;
  int with_seg;
  float *pc_out, *sn_out, *node_out;
  int32_t* seg_out;
};

bool load_one_npz(const NpzArgs& a, int64_t i, std::string* err) {
  std::vector<unsigned char> buf;
  if (!read_file(a.paths[i], &buf, err)) return false;
  std::vector<std::pair<std::string, ZipMember>> ms;
  if (!zip_members(buf, &ms, err)) return false;
  NpyView pcv, snv, somv, segv;
  if (!npz_member(ms, "pc", &pcv, err)) return false;
  if (!npz_member(ms, "sn", &snv, err)) return false;
  if (!npz_member(ms, "som_node", &somv, err)) return false;
  if (a.with_seg && !npz_member(ms, "part_label", &segv, err)) return false;
  if (pcv.cols != 3 || !pcv.is_float || snv.rows != pcv.rows ||
      snv.cols != 3 || !snv.is_float) {
    *err = std::string("npz pc/sn shape/dtype mismatch: ") + a.paths[i];
    return false;
  }
  if (pcv.rows == 0) {
    *err = std::string("npz pc member is empty: ") + a.paths[i];
    return false;
  }
  if (somv.rows != a.n_nodes || somv.cols != 3 || !somv.is_float) {
    *err = std::string("npz som_node shape/dtype mismatch: ") + a.paths[i];
    return false;
  }
  if (a.with_seg && segv.rows != pcv.rows) {
    *err = std::string("npz part_label length mismatch: ") + a.paths[i];
    return false;
  }

  std::mt19937_64 rng(a.item_seeds[i]);
  int64_t N = pcv.rows;
  std::vector<int32_t> idx;
  if (N >= a.n_points) {
    // distinct subsample (shapenet_loader.py:142-147 / shrec path)
    idx.resize(size_t(N));
    for (int64_t j = 0; j < N; j++) idx[size_t(j)] = int32_t(j);
    for (int64_t j = 0; j < a.n_points; j++) {
      std::uniform_int_distribution<int64_t> pick(j, N - 1);
      std::swap(idx[size_t(j)], idx[size_t(pick(rng))]);
    }
  } else {
    // keep all, up-resample with replacement (shapenet_loader.py:148-154)
    idx.resize(size_t(a.n_points));
    for (int64_t j = 0; j < N; j++) idx[size_t(j)] = int32_t(j);
    std::uniform_int_distribution<int64_t> pick(0, N - 1);
    for (int64_t j = N; j < a.n_points; j++)
      idx[size_t(j)] = int32_t(pick(rng));
  }

  float* pc = a.pc_out + i * a.n_points * 3;
  float* sn = a.sn_out + i * a.n_points * 3;
  float* node = a.node_out + i * a.n_nodes * 3;
  for (int64_t j = 0; j < a.n_points; j++) {
    int32_t r = idx[size_t(j)];
    for (int c = 0; c < 3; c++) {
      pc[j * 3 + c] = pcv.f[size_t(r) * 3 + c];
      sn[j * 3 + c] = snv.f[size_t(r) * 3 + c];
    }
  }
  std::memcpy(node, somv.f.data(), size_t(a.n_nodes) * 3 * sizeof(float));
  if (a.with_seg) {
    int32_t* seg = a.seg_out + i * a.n_points;
    const int32_t* sv = segv.i.empty()
        ? nullptr : segv.i.data();  // int dtypes only
    if (!sv) { *err = "part_label is not an int array"; return false; }
    for (int64_t j = 0; j < a.n_points; j++) seg[j] = sv[idx[size_t(j)]];
  }

  if (a.augment_mode)
    apply_augment(pc, sn, node, a.n_points, a.n_nodes, rng, a.augment_mode,
                  a.rot_horizontal, a.rot_perturbation,
                  a.translation_perturbation);
  return true;
}

thread_local std::string g_err;

// shared worker pool: run fn(i) over items, first error wins
template <typename F>
int run_items(int64_t n_items, int64_t n_threads, F fn) {
  if (n_threads <= 1 || n_items <= 1) {
    for (int64_t i = 0; i < n_items; i++) {
      std::string err;
      if (!fn(i, &err)) { g_err = err; return -1; }
    }
    return 0;
  }
  int64_t T = std::min<int64_t>(n_threads, n_items);
  std::atomic<int64_t> next(0);
  std::vector<std::string> errs;
  errs.resize(size_t(T));
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < T; t++) {
    threads.emplace_back([&, t]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n_items) break;
        std::string err;
        if (!fn(i, &err)) { errs[size_t(t)] = err; break; }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (auto& e : errs)
    if (!e.empty()) { g_err = e; return -1; }
  return 0;
}

}  // namespace

extern "C" {

const char* sonet_loader_error() { return g_err.c_str(); }

// Returns 0 on success, -1 on error (message via sonet_loader_error,
// from the calling thread).
int sonet_load_batch(const char** pc_paths, const char** som_paths,
                     int64_t n_items, int64_t n_points, int64_t n_nodes,
                     const uint64_t* item_seeds, int augment,
                     int rot_horizontal, int rot_perturbation,
                     int translation_perturbation, int64_t n_threads,
                     float* pc_out, float* sn_out, float* node_out) {
  Args a{pc_paths, som_paths, n_items, n_points, n_nodes, item_seeds,
         augment, rot_horizontal, rot_perturbation, translation_perturbation,
         pc_out, sn_out, node_out};
  return run_items(n_items, n_threads, [&](int64_t i, std::string* err) {
    return load_one(a, i, err);
  });
}

// npz-layout batch (SHREC {pc, sn, som_node}; ShapeNetPart adds
// part_label).  augment_mode: 0 none, 1 full modelnet/shrec stack,
// 2 shapenet jitter+scale.  seg_out may be null when with_seg == 0.
int sonet_load_npz_batch(const char** paths, int64_t n_items,
                         int64_t n_points, int64_t n_nodes,
                         const uint64_t* item_seeds, int augment_mode,
                         int rot_horizontal, int rot_perturbation,
                         int translation_perturbation, int with_seg,
                         int64_t n_threads, float* pc_out, float* sn_out,
                         float* node_out, int32_t* seg_out) {
  NpzArgs a{paths, n_items, n_points, n_nodes, item_seeds, augment_mode,
            rot_horizontal, rot_perturbation, translation_perturbation,
            with_seg, pc_out, sn_out, node_out, seg_out};
  return run_items(n_items, n_threads, [&](int64_t i, std::string* err) {
    return load_one_npz(a, i, err);
  });
}

}  // extern "C"
