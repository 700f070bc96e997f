// Copied from dmnerf_tpu/native/marching.cpp.
// Native marching tetrahedra for dmnerf_torch.
//
// Same algorithm and case tables as dmnerf_torch/mesh/marching.py (each cube split
// into 6 tetrahedra around the 0-6 diagonal; 14 non-trivial sign cases), with
// vertex dedup via a canonical-edge hash map. ~20-40x the numpy implementation
// on the reference's 256^3 meshing grids (single-core host).
//
// Exposed via the CPython C API (no pybind11 in this environment):
//   _marching_native.marching_tetrahedra(volume_f32_3d, level)
//     -> (verts float64 [V,3] in index coords, faces int64 [F,3])

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

// cube corner offsets (x, y, z) — matches _CORNERS in marching.py
static const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// 6 tetrahedra sharing the 0-6 main diagonal — matches _TETS
static const int TETS[6][4] = {
    {0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
    {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6},
};

// tet edges (corner_a, corner_b) — matches _TET_EDGES
static const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3},
                                    {1, 2}, {1, 3}, {2, 3}};

// case -> up to 2 triangles of tet-edge indices; -1 terminated — matches _CASES
struct Case { int tris[2][3]; int n; };
static Case CASES[16];

void init_cases() {
  for (int i = 0; i < 16; i++) CASES[i].n = 0;
  auto set1 = [](int c, int a, int b, int d) {
    CASES[c].tris[0][0] = a; CASES[c].tris[0][1] = b; CASES[c].tris[0][2] = d;
    CASES[c].n = 1;
  };
  auto set2 = [](int c, int a, int b, int d, int e, int f, int g) {
    CASES[c].tris[0][0] = a; CASES[c].tris[0][1] = b; CASES[c].tris[0][2] = d;
    CASES[c].tris[1][0] = e; CASES[c].tris[1][1] = f; CASES[c].tris[1][2] = g;
    CASES[c].n = 2;
  };
  set1(0b0001, 0, 1, 2);
  set1(0b0010, 0, 3, 4);
  set1(0b0100, 1, 3, 5);
  set1(0b1000, 2, 4, 5);
  set2(0b0011, 1, 3, 4, 1, 4, 2);
  set2(0b0101, 0, 2, 5, 0, 5, 3);
  set2(0b1001, 0, 4, 5, 0, 5, 1);
  set2(0b0110, 0, 5, 4, 0, 1, 5);
  set2(0b1010, 0, 5, 2, 0, 3, 5);
  set2(0b1100, 1, 4, 3, 1, 2, 4);
  set1(0b1110, 0, 2, 1);
  set1(0b1101, 0, 4, 3);
  set1(0b1011, 1, 5, 3);
  set1(0b0111, 2, 5, 4);
}

struct V3 { double x, y, z; };

PyObject* marching_tetrahedra(PyObject*, PyObject* args) {
  PyArrayObject* vol_obj = nullptr;
  double level;
  if (!PyArg_ParseTuple(args, "O!d", &PyArray_Type, &vol_obj, &level))
    return nullptr;
  if (PyArray_NDIM(vol_obj) != 3 || PyArray_TYPE(vol_obj) != NPY_FLOAT32 ||
      !PyArray_IS_C_CONTIGUOUS(vol_obj)) {
    PyErr_SetString(PyExc_ValueError, "volume must be C-contiguous float32 [D0,D1,D2]");
    return nullptr;
  }
  const npy_intp* dims = PyArray_DIMS(vol_obj);
  const int64_t D0 = dims[0], D1 = dims[1], D2 = dims[2];
  const float* vol = static_cast<const float*>(PyArray_DATA(vol_obj));
  const float lv = static_cast<float>(level);

  std::unordered_map<int64_t, int32_t> edge_to_vid;
  std::vector<V3> verts;
  std::vector<int64_t> faces;
  edge_to_vid.reserve(1 << 18);

  auto corner_id = [&](int64_t x, int64_t y, int64_t z) -> int64_t {
    return (x * D1 + y) * D2 + z;
  };

  auto vertex_on_edge = [&](int64_t ca, int64_t cb, float va, float vb) -> int32_t {
    int64_t lo = ca, hi = cb;
    float vlo = va, vhi = vb;
    if (lo > hi) { lo = cb; hi = ca; vlo = vb; vhi = va; }
    int64_t key = lo * (D0 * D1 * D2) + hi;
    auto it = edge_to_vid.find(key);
    if (it != edge_to_vid.end()) return it->second;
    float denom = vhi - vlo;
    float t = denom == 0.0f ? 0.5f : (lv - vlo) / denom;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;
    double ax = double(lo / (D1 * D2)), ay = double((lo / D2) % D1), az = double(lo % D2);
    double bx = double(hi / (D1 * D2)), by = double((hi / D2) % D1), bz = double(hi % D2);
    V3 p{ax + t * (bx - ax), ay + t * (by - ay), az + t * (bz - az)};
    int32_t vid = static_cast<int32_t>(verts.size());
    verts.push_back(p);
    edge_to_vid.emplace(key, vid);
    return vid;
  };

  Py_BEGIN_ALLOW_THREADS
  for (int64_t x = 0; x + 1 < D0; x++) {
    for (int64_t y = 0; y + 1 < D1; y++) {
      const float* row = vol + (x * D1 + y) * D2;
      for (int64_t z = 0; z + 1 < D2; z++) {
        // gather cube corner values
        float cv[8];
        int64_t cid[8];
        float vmin = 1e30f, vmax = -1e30f;
        for (int c = 0; c < 8; c++) {
          int64_t cx = x + CORNERS[c][0], cy = y + CORNERS[c][1],
                  cz = z + CORNERS[c][2];
          float v = vol[(cx * D1 + cy) * D2 + cz];
          cv[c] = v;
          cid[c] = corner_id(cx, cy, cz);
          if (v < vmin) vmin = v;
          if (v > vmax) vmax = v;
        }
        if (!(vmin < lv && vmax > lv)) continue;
        for (int t = 0; t < 6; t++) {
          int cs = 0;
          for (int k = 0; k < 4; k++)
            if (cv[TETS[t][k]] > lv) cs |= 1 << k;
          const Case& c = CASES[cs];
          for (int tri = 0; tri < c.n; tri++) {
            int32_t ids[3];
            for (int e = 0; e < 3; e++) {
              int edge = c.tris[tri][e];
              int a = TETS[t][TET_EDGES[edge][0]];
              int b = TETS[t][TET_EDGES[edge][1]];
              ids[e] = vertex_on_edge(cid[a], cid[b], cv[a], cv[b]);
            }
            if (ids[0] != ids[1] && ids[1] != ids[2] && ids[0] != ids[2]) {
              faces.push_back(ids[0]);
              faces.push_back(ids[1]);
              faces.push_back(ids[2]);
            }
          }
        }
      }
    }
  }
  Py_END_ALLOW_THREADS

  npy_intp vdims[2] = {static_cast<npy_intp>(verts.size()), 3};
  npy_intp fdims[2] = {static_cast<npy_intp>(faces.size() / 3), 3};
  PyObject* varr = PyArray_SimpleNew(2, vdims, NPY_FLOAT64);
  PyObject* farr = PyArray_SimpleNew(2, fdims, NPY_INT64);
  if (!varr || !farr) {
    Py_XDECREF(varr);
    Py_XDECREF(farr);
    return nullptr;
  }
  if (!verts.empty())
    memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(varr)), verts.data(),
           verts.size() * sizeof(V3));
  if (!faces.empty())
    memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(farr)), faces.data(),
           faces.size() * sizeof(int64_t));
  // PyTuple_Pack takes new references; drop ours or the arrays leak
  PyObject* out = PyTuple_Pack(2, varr, farr);
  Py_DECREF(varr);
  Py_DECREF(farr);
  return out;
}

// Marching cubes with caller-supplied tables (generated by
// dmnerf_torch/mesh/mc_tables.py — see its docstring for the derivation):
//   marching_cubes(volume_f32_3d, level, tri_table_i32 [256, 3*MAX],
//                  edges_i32 [12, 2]) -> (verts f64 [V,3], faces i64 [F,3])
PyObject* marching_cubes(PyObject*, PyObject* args) {
  PyArrayObject *vol_obj = nullptr, *tt_obj = nullptr, *eg_obj = nullptr;
  double level;
  if (!PyArg_ParseTuple(args, "O!dO!O!", &PyArray_Type, &vol_obj, &level,
                        &PyArray_Type, &tt_obj, &PyArray_Type, &eg_obj))
    return nullptr;
  if (PyArray_NDIM(vol_obj) != 3 || PyArray_TYPE(vol_obj) != NPY_FLOAT32 ||
      !PyArray_IS_C_CONTIGUOUS(vol_obj) ||
      PyArray_NDIM(tt_obj) != 2 || PyArray_TYPE(tt_obj) != NPY_INT32 ||
      !PyArray_IS_C_CONTIGUOUS(tt_obj) || PyArray_DIM(tt_obj, 0) != 256 ||
      PyArray_NDIM(eg_obj) != 2 || PyArray_TYPE(eg_obj) != NPY_INT32 ||
      !PyArray_IS_C_CONTIGUOUS(eg_obj) || PyArray_DIM(eg_obj, 0) != 12) {
    PyErr_SetString(PyExc_ValueError,
                    "expected (f32 volume [D0,D1,D2], level, i32 tri_table "
                    "[256,3k], i32 edges [12,2])");
    return nullptr;
  }
  const npy_intp* dims = PyArray_DIMS(vol_obj);
  const int64_t D0 = dims[0], D1 = dims[1], D2 = dims[2];
  const float* vol = static_cast<const float*>(PyArray_DATA(vol_obj));
  const int32_t* tt = static_cast<const int32_t*>(PyArray_DATA(tt_obj));
  const int64_t tt_w = PyArray_DIM(tt_obj, 1);
  const int32_t* eg = static_cast<const int32_t*>(PyArray_DATA(eg_obj));
  const float lv = static_cast<float>(level);

  std::unordered_map<int64_t, int32_t> edge_to_vid;
  std::vector<V3> verts;
  std::vector<int64_t> faces;
  edge_to_vid.reserve(1 << 18);

  auto vertex_on_edge = [&](int64_t ca, int64_t cb, float va, float vb) -> int32_t {
    int64_t lo = ca, hi = cb;
    float vlo = va, vhi = vb;
    if (lo > hi) { lo = cb; hi = ca; vlo = vb; vhi = va; }
    int64_t key = lo * (D0 * D1 * D2) + hi;
    auto it = edge_to_vid.find(key);
    if (it != edge_to_vid.end()) return it->second;
    float denom = vhi - vlo;
    float t = denom == 0.0f ? 0.5f : (lv - vlo) / denom;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;
    double ax = double(lo / (D1 * D2)), ay = double((lo / D2) % D1), az = double(lo % D2);
    double bx = double(hi / (D1 * D2)), by = double((hi / D2) % D1), bz = double(hi % D2);
    V3 p{ax + t * (bx - ax), ay + t * (by - ay), az + t * (bz - az)};
    int32_t vid = static_cast<int32_t>(verts.size());
    verts.push_back(p);
    edge_to_vid.emplace(key, vid);
    return vid;
  };

  Py_BEGIN_ALLOW_THREADS
  for (int64_t x = 0; x + 1 < D0; x++) {
    for (int64_t y = 0; y + 1 < D1; y++) {
      for (int64_t z = 0; z + 1 < D2; z++) {
        float cv[8];
        int64_t cid[8];
        int cs = 0;
        float vmin = 1e30f, vmax = -1e30f;
        for (int c = 0; c < 8; c++) {
          int64_t cx = x + CORNERS[c][0], cy = y + CORNERS[c][1],
                  cz = z + CORNERS[c][2];
          float v = vol[(cx * D1 + cy) * D2 + cz];
          cv[c] = v;
          cid[c] = (cx * D1 + cy) * D2 + cz;
          if (v > lv) cs |= 1 << c;
          if (v < vmin) vmin = v;
          if (v > vmax) vmax = v;
        }
        if (!(vmin < lv && vmax > lv)) continue;
        const int32_t* row = tt + cs * tt_w;
        for (int64_t k = 0; k + 2 < tt_w && row[k] >= 0; k += 3) {
          int32_t ids[3];
          for (int e = 0; e < 3; e++) {
            int a = eg[2 * row[k + e]];
            int b = eg[2 * row[k + e] + 1];
            ids[e] = vertex_on_edge(cid[a], cid[b], cv[a], cv[b]);
          }
          if (ids[0] != ids[1] && ids[1] != ids[2] && ids[0] != ids[2]) {
            faces.push_back(ids[0]);
            faces.push_back(ids[1]);
            faces.push_back(ids[2]);
          }
        }
      }
    }
  }
  Py_END_ALLOW_THREADS

  npy_intp vdims[2] = {static_cast<npy_intp>(verts.size()), 3};
  npy_intp fdims[2] = {static_cast<npy_intp>(faces.size() / 3), 3};
  PyObject* varr = PyArray_SimpleNew(2, vdims, NPY_FLOAT64);
  PyObject* farr = PyArray_SimpleNew(2, fdims, NPY_INT64);
  if (!varr || !farr) {
    Py_XDECREF(varr);
    Py_XDECREF(farr);
    return nullptr;
  }
  if (!verts.empty())
    memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(varr)), verts.data(),
           verts.size() * sizeof(V3));
  if (!faces.empty())
    memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(farr)), faces.data(),
           faces.size() * sizeof(int64_t));
  // PyTuple_Pack takes new references; drop ours or the arrays leak
  PyObject* out = PyTuple_Pack(2, varr, farr);
  Py_DECREF(varr);
  Py_DECREF(farr);
  return out;
}

PyMethodDef methods[] = {
    {"marching_tetrahedra", marching_tetrahedra, METH_VARARGS,
     "marching_tetrahedra(volume_f32, level) -> (verts, faces)"},
    {"marching_cubes", marching_cubes, METH_VARARGS,
     "marching_cubes(volume_f32, level, tri_table_i32, edges_i32) -> (verts, faces)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_marching_native", nullptr, -1,
                         methods};

}  // namespace

PyMODINIT_FUNC PyInit__marching_native(void) {
  import_array();
  init_cases();
  return PyModule_Create(&moduledef);
}
